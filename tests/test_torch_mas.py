"""MAS in the PyTorch port (`arttts_tpu_torch/ops/mas.py`) against the JAX
package's three MAS implementations, bit for bit, on the CPU.

The port's plain version (what the wrapper runs on CPU tensors, and what
`chip_smoke.py` holds kernel K6 against on the card) and the wrapper are
compared with `assert_array_equal` against the JAX NumPy oracle, its
`lax.scan` version and its Pallas kernel in interpret mode, and against the
port's own copy of the oracle. Only max and add in float32 happen in the
DP, so nothing may differ by a bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arttts_tpu.ops.mas import mas_reference_numpy as j_reference
from arttts_tpu.ops.mas import mas_scan
from arttts_tpu.ops.mas_pallas import mas_pallas
from arttts_tpu_torch.ops import mas as pmas


def _problem(rng, B, T_x, T_y, integer=False):
    """Random masked log-prior with t_y >= t_x (an alignment needs it), as
    `tests/test_mas.py` draws it; `integer` gives small whole numbers, so
    equal DP entries occur and the strict `<` of the backtrace decides."""
    if integer:
        value = rng.integers(-2, 3, size=(B, T_x, T_y)).astype(np.float32)
    else:
        value = rng.standard_normal((B, T_x, T_y)).astype(np.float32)
    t_xs = rng.integers(min(2, T_x), T_x + 1, size=B).astype(np.int32)
    t_ys = np.array([rng.integers(t_x, T_y + 1) for t_x in t_xs], dtype=np.int32)
    for i in range(B):
        value[i, t_xs[i]:, :] = 0.0
        value[i, :, t_ys[i]:] = 0.0
    return value, t_xs, t_ys


def _mask(t_xs, t_ys, T_x, T_y):
    x_mask = (np.arange(T_x)[None] < t_xs[:, None]).astype(np.float32)
    y_mask = (np.arange(T_y)[None] < t_ys[:, None]).astype(np.float32)
    return x_mask[:, :, None] * y_mask[:, None, :]


def _all_equal(value, t_xs, t_ys):
    golden = j_reference(value, t_xs, t_ys)
    jv, jx, jy = jnp.asarray(value), jnp.asarray(t_xs), jnp.asarray(t_ys)
    others = {
        "jax mas_scan": np.asarray(mas_scan(jv, jx, jy)),
        "jax mas_pallas(interpret)": np.asarray(mas_pallas(jv, jx, jy, interpret=True)),
        "port mas_reference_numpy": pmas.mas_reference_numpy(value, t_xs, t_ys),
        "port maximum_path_plain": pmas.maximum_path_plain(
            torch.from_numpy(value), torch.from_numpy(t_xs), torch.from_numpy(t_ys)).numpy(),
        "port maximum_path": pmas.maximum_path(
            torch.from_numpy(value),
            torch.from_numpy(_mask(t_xs, t_ys, *value.shape[1:]))).numpy(),
    }
    for name, got in others.items():
        assert got.shape == golden.shape, name
        np.testing.assert_array_equal(got.astype(np.int32), golden, err_msg=name)
    return golden


@pytest.mark.parametrize("B,T_x,T_y", [
    (1, 1, 1), (2, 3, 3), (3, 8, 64), (2, 40, 40), (5, 13, 29),
    (2, 12, 61),  # T_y not a multiple of the TPU kernel's unroll of 4
])
def test_mas_bit_exact_against_jax(B, T_x, T_y):
    rng = np.random.default_rng(100 * T_x + T_y)
    _all_equal(*_problem(rng, B, T_x, T_y))


def _path_breaking_ties_the_other_way(value, t_xs, t_ys):
    """The oracle's DP with `<=` in place of the backtrace's `<`."""
    paths = np.zeros(value.shape, np.int32)
    for i in range(value.shape[0]):
        t_x, t_y = int(t_xs[i]), int(t_ys[i])
        v = value[i].copy()
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = pmas.MAX_NEG_VAL if x == y else v[x, y - 1]
                v_prev = (0.0 if y == 0 else pmas.MAX_NEG_VAL) if x == 0 else v[x - 1, y - 1]
                v[x, y] = max(v_cur, v_prev) + v[x, y]
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            paths[i, index, y] = 1
            if index != 0 and (index == y or v[index, y - 1] <= v[index - 1, y - 1]):
                index -= 1
    return paths


def test_mas_ties_bit_exact():
    """Small whole numbers: DP entries tie, and every implementation must
    break each tie as the reference's strict `<` does."""
    rng = np.random.default_rng(0)
    value, t_xs, t_ys = _problem(rng, 4, 10, 37, integer=True)
    golden = _all_equal(value, t_xs, t_ys)
    # the ties decide here: breaking them the other way gives other paths
    assert (_path_breaking_ties_the_other_way(value, t_xs, t_ys) != golden).any()


def test_mas_path_properties():
    rng = np.random.default_rng(11)
    value, t_xs, t_ys = _problem(rng, 3, 11, 37)
    path = pmas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(t_xs),
                                   torch.from_numpy(t_ys)).numpy()
    assert path.dtype == np.float32
    for i in range(3):
        p = path[i, : t_xs[i], : t_ys[i]]
        np.testing.assert_array_equal(p.sum(axis=0), np.ones(t_ys[i]))  # one token a frame
        durations = p.sum(axis=1)
        assert (durations >= 1).all() and durations.sum() == t_ys[i]
        assert (np.diff(p.argmax(axis=0)) >= 0).all()  # monotonic
        assert path[i, t_xs[i]:, :].sum() == 0 and path[i, :, t_ys[i]:].sum() == 0


def test_maximum_path_wrapper_contract():
    """`maximum_path(value, mask)` masks the value and takes the lengths
    from the mask, as the JAX wrapper does; it counts no launch on the CPU."""
    rng = np.random.default_rng(12)
    B, T_x, T_y = 3, 9, 25
    value = rng.standard_normal((B, T_x, T_y)).astype(np.float32)
    t_xs = np.array([9, 5, 7], dtype=np.int32)
    t_ys = np.array([25, 18, 7], dtype=np.int32)
    mask = _mask(t_xs, t_ys, T_x, T_y)
    golden = j_reference(value * mask, t_xs, t_ys)
    before = (pmas.maximum_path.launches, pmas.maximum_path_plain.cuda_calls)
    got = pmas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert (pmas.maximum_path.launches, pmas.maximum_path_plain.cuda_calls) == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int32), golden)
