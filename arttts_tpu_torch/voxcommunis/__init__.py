"""VoxCommunis phone features for the multi-speaker articulatory model (the
port's copy of the serving part of `arttts_tpu/voxcommunis/`)."""
