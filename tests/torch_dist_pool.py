"""A pool of gloo ranks on the CPU for the port's multi-process tests
(`tests/test_torch_parallel.py`, `tests/test_torch_sp.py`,
`tests/test_torch_tp.py`), and the jobs they run.

`RankPool(world)` spawns `world` processes once (one torch thread each),
which join one gloo process group through the port's `init_distributed`
and then run jobs: `pool.run(job, *args)` sends the same job to every rank
and returns the ranks' results in rank order, raising with the traceback
if any rank fails. The jobs are functions of this module, which imports no
JAX, so that a rank imports only torch and the port.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, jobs, results):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from arttts_tpu_torch.parallel.distributed import init_distributed

    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank, device="cpu")
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args = job
            try:
                results.put((rank, True, fn(*args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        port = free_port()
        self.world = world
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, world, port, self.jobs[r],
                                                       self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 300.0):
        for q in self.jobs:
            q.put((fn, args))
        got, errors = {}, []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"a rank gave no result in {timeout} s "
                                   f"(alive: {[p.is_alive() for p in self.procs]})") from None
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        assert not any(p.is_alive() for p in self.procs)


def _numpy_state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def port_model(cfg, state=None):
    """The port's GradTTSModel on the CPU, with `state` (numpy) if given."""
    from arttts_tpu_torch.models.tts import GradTTSModel

    model = GradTTSModel(cfg)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


# ---- data parallelism ---------------------------------------------------


def dp_steps(cfg, state, batches, out_size, lr):
    """This rank's rows of each global batch through `train_step` under
    DDP over a data mesh of every rank. Returns each step's metrics and the
    parameters after the last."""
    from arttts_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from arttts_tpu_torch.train.losses import loss_for_model
    from arttts_tpu_torch.train.step import data_parallel, make_optimizer, train_step

    mesh = make_mesh(device_type="cpu")
    model = port_model(cfg, state)
    loss_fn = loss_for_model(cfg.name)
    ddp = data_parallel(model, loss_fn, mesh.groups["data"])
    opt = make_optimizer(model, lr)
    metrics = []
    for b in batches:
        m = train_step(model, opt, shard_batch(mesh, b), None, out_size, loss_fn=loss_fn,
                       ddp=ddp)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _numpy_state(model)


def replicate_and_mesh(cfg, state):
    """Rank r perturbs its parameters by r, then `replicate`; returns the
    parameters, and the coordinates, shape and group sizes of a 2 x (w/2)
    mesh and a w x 1 mesh."""
    import torch.distributed as dist

    from arttts_tpu_torch.parallel.mesh import make_mesh, replicate

    model = port_model(cfg, state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(float(dist.get_rank()))
    replicate(make_mesh(device_type="cpu"), model)
    meshes = []
    for n_data in (2, dist.get_world_size()):
        m = make_mesh(n_data=n_data, device_type="cpu")
        meshes.append((m.coords, m.shape, {a: None if g is None else dist.get_world_size(g)
                                          for a, g in m.groups.items()}))
    return _numpy_state(model), meshes


# ---- sequence parallelism -------------------------------------------------


def sp_score(cfg, state, xt, mask, mu, t, n_model):
    """The score function `make_score_fn(mesh=...)` gives over a
    (world / n_model) x n_model mesh, on this rank's chunk of the inputs
    (numpy (B, T, F)). Returns (its chunk of the output, the function's
    qualified name, collectives an evaluation)."""
    import torch.distributed as dist

    from arttts_tpu_torch.models.unet2d_fast import make_score_fn
    from arttts_tpu_torch.parallel.mesh import local_slice, make_mesh

    mesh = make_mesh(n_data=dist.get_world_size() // n_model, n_model=n_model,
                     device_type="cpu")
    model = port_model(cfg, state)
    T = xt.shape[1]
    cut = local_slice(mesh, "model", T)
    fn = make_score_fn(model, T, mesh=mesh)
    with torch.no_grad():
        out = fn(*(torch.from_numpy(a[:, cut]) for a in (xt, mask, mu)), torch.from_numpy(t))
    return out.numpy(), fn.__qualname__, fn.comm.calls


def sp_synthesize(cfg, state, x, x_lengths, kwargs, n_model):
    """`synthesize(mesh=...)` over a (world / n_model) x n_model mesh, the
    generator seeded 7 on every rank. Returns (mu_y, dec, attn, y_lengths)."""
    import torch.distributed as dist

    from arttts_tpu_torch.infer.sampler import synthesize
    from arttts_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=dist.get_world_size() // n_model, n_model=n_model,
                     device_type="cpu")
    model = port_model(cfg, state).eval()
    out = synthesize(model, torch.Generator().manual_seed(7), x, x_lengths, device="cpu",
                     mesh=mesh, **kwargs)
    return [np.asarray(o) for o in out]


# ---- tensor parallelism ---------------------------------------------------


def _reference_name(name: str) -> str:
    """A sharded model's parameter name -> the unsharded model's."""
    return name.replace("parametrizations.", "").replace(".original", "")


def tp_steps(cfg, state, batches, out_size, lr, n_data, n_model):
    """`shard_tp` over an n_data x n_model mesh of every rank, then
    `train_step` on this rank's rows of each global batch (DDP over the
    "data" axis when it is over 1). Returns each step's metrics, the
    gathered parameters after the last (numpy, the unsharded names),
    `tp_sharding`'s layout, the stored shapes of each parameter and of its
    Adam moments, and the steps' all-reduces over the model row and their
    bytes."""
    from arttts_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from arttts_tpu_torch.parallel.tp import shard_tp, tensor_parallel, tp_sharding, tp_state_dict
    from arttts_tpu_torch.train.losses import loss_for_model
    from arttts_tpu_torch.train.step import data_parallel, make_optimizer, train_step

    mesh = make_mesh(n_data=n_data, n_model=n_model, device_type="cpu")
    model = port_model(cfg, state)
    layout = tp_sharding(mesh, model)
    shard_tp(mesh, model)
    loss_fn = loss_for_model(cfg.name)
    ddp = data_parallel(model, loss_fn, mesh.groups["data"]) if n_data > 1 else None
    opt = make_optimizer(model, lr)
    metrics = []
    for b in batches:
        m = train_step(model, opt, shard_batch(mesh, b), None, out_size, loss_fn=loss_fn,
                       ddp=ddp)
        metrics.append({k: float(v) for k, v in m.items()})
    tp = tensor_parallel(model)
    comm = None if tp is None else (tp.comm.calls, tp.comm.bytes)
    stored = {_reference_name(n): (tuple(p.shape), tuple(opt.state[p]["exp_avg"].shape),
                                   tuple(opt.state[p]["exp_avg_sq"].shape))
              for n, p in model.named_parameters()}
    gathered = {k: v.detach().numpy().copy() for k, v in tp_state_dict(model).items()}
    return metrics, gathered, layout, stored, comm


class ItemDataset:
    """A `Trainer` dataset over a list of items ({"x", "y"})."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return np.array([it["y"].shape[0] for it in self.items])


def trainer_epoch(exp, items, log_dir, n_data, n_model):
    """One `Trainer` epoch over an n_data x n_model mesh, then a second
    `Trainer` resumed from the first's `grad_final`. A mesh smaller than
    the world (n_model 1) takes the first n_data ranks; the others return
    None. Returns the digests of the trained and the resumed state (weights
    and Adam), the checkpoints this rank wrote, the resumed start epoch and
    the files in `log_dir`."""
    import hashlib
    from pathlib import Path

    import torch.distributed as dist

    from arttts_tpu_torch.parallel.mesh import Mesh, make_mesh
    from arttts_tpu_torch.train import trainer as trainer_mod

    if n_data * n_model == dist.get_world_size():
        mesh = make_mesh(n_data=n_data, n_model=n_model, device_type="cpu")
    else:
        assert n_model == 1
        group = dist.new_group(list(range(n_data)))  # every rank takes part
        rank = dist.get_rank()
        if rank >= n_data:
            return None
        mesh = Mesh(shape={"data": n_data, "model": 1}, coords={"data": rank, "model": 0},
                    groups={"data": group, "model": None}, device=torch.device("cpu"))

    def digest(trainer):
        opt = trainer.optimizer.state_dict()["state"]
        h = hashlib.sha256()
        for t in [*trainer.model.state_dict().values(),
                  *(v for k in sorted(opt) for v in opt[k].values())]:
            h.update(t.detach().numpy().tobytes())
        return h.hexdigest()

    saves, real_save = [], trainer_mod.save_checkpoint

    def save(log_dir_, name, *args, **kwargs):
        saves.append(name)
        return real_save(log_dir_, name, *args, **kwargs)

    trainer_mod.save_checkpoint = save
    try:
        trainer = trainer_mod.Trainer(exp, ItemDataset(items), log_dir=str(log_dir), device="cpu",
                                      mesh=mesh)
        trainer.fit(n_epochs=1)
        resumed = trainer_mod.Trainer(exp, ItemDataset(items), log_dir=str(log_dir),
                                      device="cpu", mesh=mesh)
        start = resumed.resume(str(Path(log_dir) / "grad_final"))
    finally:
        trainer_mod.save_checkpoint = real_save
    return dict(digest=digest(trainer), resumed_digest=digest(resumed), saves=saves,
                start=start, is_main=trainer.is_main, ddp=trainer.ddp is not None,
                rows=[trainer.train_loader.batcher.rows.start,
                      trainer.train_loader.batcher.rows.stop],
                files=sorted(p.name for p in Path(log_dir).iterdir()))


def lockstep_step(cfg, state, batch, out_size, lr):
    """One `train_step` of a model `replicate_tp` laid out whole over a
    1 x world mesh, each rank's pinned t moved by 0.01 times its model
    coordinate (as if its backward's bits differed). Returns the loss this
    rank computed, its parameters after the step and the row's
    all-reduces."""
    import torch.distributed as dist

    from arttts_tpu_torch.parallel.mesh import make_mesh
    from arttts_tpu_torch.parallel.tp import replicate_tp, tensor_parallel
    from arttts_tpu_torch.train.losses import loss_for_model
    from arttts_tpu_torch.train.step import make_optimizer, train_step

    mesh = make_mesh(n_data=1, n_model=dist.get_world_size(), device_type="cpu")
    model = replicate_tp(mesh, port_model(cfg, state))
    opt = make_optimizer(model, lr)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["pinned_t"] = b["pinned_t"] + 0.01 * mesh.coords["model"]
    m = train_step(model, opt, b, None, out_size, loss_fn=loss_for_model(cfg.name))
    tp = tensor_parallel(model)
    return float(m["total_loss"]), _numpy_state(model), (tp.comm.calls, tp.comm.bytes)
