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


# ---- K6's schedule (csrc/mas.cu), emulated on the CPU ------------------------
_LANE_J = (1, 2, 4, 6, 8, 12, 16, 24, 32)  # the kernel's instantiated positions a lane


def _k6_schedule(value, t_xs, t_ys, max_j=32):
    """csrc/mas.cu's schedule in NumPy, vectorised over lanes: route A (one
    warp, J = ceil(T_x / 32) rounded up to an instantiated J) up to
    32 * max_j positions, else route B (W warps of 32 * max_j positions,
    the boundary value through a parity-buffered `bnd`); value staged in
    16-frame chunks into swizzled 32-float rows (route A), zero past T_y;
    slots updated from J-1 down in place, route A's whole 4-frame pieces
    without the band tests when t_x <= t_y and without x == y from y >= t_x
    on (cells out of the band then get max + value, not value); one ballot
    word per slot and frame, bit 0 of word 0 cleared; the backtrace walks
    (t, j) with index = t * J + j in 32-frame chunks (route A two frames a
    step); the path is idx[y] == x. max_j < 32 puts route B's hand-off at
    small sizes."""
    B, T_x, T_y = value.shape
    if T_x <= 32 * max_j:
        J = next(j for j in _LANE_J if j >= -(-T_x // 32))
        W = 1
    else:
        J, W = max_j, -(-T_x // (32 * max_j))
    L = 32 * W  # lanes of all warps, lane-major within a warp
    WJ = W * J
    neg = np.float32(-1e9)
    lanes = np.arange(L)
    paths = np.zeros((B, T_x, T_y), np.float32)
    for b in range(B):
        t_x, t_y = int(t_xs[b]), int(t_ys[b])
        vb = value[b]
        col = np.zeros((L, J), np.float32)
        dec = np.zeros((T_y, WJ), np.uint64)
        bnd = np.zeros((2, W), np.float32)
        stage = np.zeros((32 * J, 32), np.float32)
        for c in range(-(-t_y // 16)):
            if W == 1:  # route A: chunk c into half c % 2, pieces swizzled by lane
                y0, half = 16 * c, (c % 2) * 4
                for k in range(4):
                    for x in range(T_x):
                        pos = (half + k) ^ ((x // J) & 7)
                        ys = y0 + 4 * k + np.arange(4)
                        stage[x, 4 * pos:4 * pos + 4] = np.where(
                            ys < T_y, vb[x, np.minimum(ys, T_y - 1)], 0)
            for f in range(16):
                y = 16 * c + f
                if y >= t_y:
                    break
                if W == 1:
                    pos = 4 * (((c % 2) * 4 + f // 4) ^ (lanes & 7)) + f % 4
                    v = stage[(lanes * J)[:, None] + np.arange(J), pos[:, None]]
                else:
                    xs = (lanes * J)[:, None] + np.arange(J)
                    v = np.where(xs < T_x, vb[np.minimum(xs, T_x - 1), y], 0).astype(np.float32)
                pm0 = np.roll(col[:, J - 1], 1)  # __shfl_up_sync within each warp
                pm0[0] = 0 if y == 0 else neg
                for w in range(1, W):
                    pm0[32 * w] = bnd[(y + 1) % 2, w - 1]
                base = lanes * J
                lo = max(0, t_x + y - t_y) - base
                hi = min(t_x, y + 1) - base
                words = np.zeros((W, J), np.uint64)
                # route A's tests on a whole 4-frame piece when t_x <= t_y:
                # x == y alone while y < t_x, none after; else the band too
                y4 = y - y % 4
                tests = 2 if W > 1 or y4 + 4 > t_y or t_x > t_y else (1 if y4 < t_x else 0)
                for j in range(J - 1, -1, -1):
                    p = col[:, j].copy()
                    pm = col[:, j - 1] if j > 0 else pm0
                    diag = (j == y - base) & (tests >= 1)
                    m = np.maximum(np.where(diag, neg, p), pm) + v[:, j]
                    col[:, j] = np.where(((j >= lo) & (j < hi)) | (tests < 2), m, v[:, j])
                    d = (diag | (p < pm)).reshape(W, 32).astype(np.uint64)
                    words[:, j] = (d << np.arange(32, dtype=np.uint64)).sum(1)
                words[0, 0] &= ~np.uint64(1)
                dec[y] = words.reshape(-1)
                bnd[y % 2] = col[31::32, J - 1]
        idx = np.full(T_y, -1)
        i0 = max(t_x - 1, 0)
        t, j = i0 // J, i0 % J
        chunks = [(y_hi, max(y_hi - 31, 0)) for y_hi in range(t_y - 1, -1, -32)]
        def below(t, j):
            return (t - 1, J - 1) if j == 0 else (t, j - 1)

        for y_hi, y_lo in chunks:
            staged = dec[y_lo:y_hi + 1].reshape(-1)

            def bit(y, t, j):
                return (int(staged[(y - y_lo) * WJ + (t >> 5) * J + j]) >> (t & 31)) & 1

            y = y_hi
            while W == 1 and y > y_lo:  # route A: two frames a step, frame y-1's
                # candidates read with frame y's
                t1, j1 = below(t, j)
                here, stay = bit(y, t, j), bit(y - 1, t, j)
                down = bit(y - 1, t1, j1) if t1 >= 0 else 0
                idx[y] = t * J + j
                if here:
                    t, j = t1, j1
                idx[y - 1] = t * J + j
                if (down if here else stay):
                    t, j = below(t, j)
                y -= 2
            while y >= y_lo:  # route B, or an odd frame left
                idx[y] = t * J + j
                if bit(y, t, j):
                    t, j = below(t, j)
                y -= 1
        paths[b] = (idx[None, :] == np.arange(T_x)[:, None])
    return paths


@pytest.mark.parametrize("T_x,T_y,max_j,integer", [
    (1, 37, 32, False),
    (31, 70, 32, False),
    (33, 101, 32, True),
    (97, 250, 32, False),
    (192, 301, 32, True),
    (97, 250, 2, False),  # route B: 2 warps of 64 positions
    (192, 301, 2, True),  # route B: 3 warps
])
def test_k6_schedule_bit_exact(T_x, T_y, max_j, integer):
    """The kernel's schedule (lane mapping, slot-0 shuffle, in-place slot
    order, the band tests it skips, staging with a ragged tail, ballot
    words and their lookup, route B's hand-off) gives the plain version's
    and the oracle's path bit for bit, ties and t_x > t_y included."""
    rng = np.random.default_rng(7 * T_x + T_y)
    value, t_xs, t_ys = _problem(rng, 3, T_x, T_y, integer=integer)
    t_xs[0], t_ys[0] = T_x, T_y  # one utterance fills the bucket
    if T_x > 1:  # and one has more text positions than frames (t_x > t_y)
        t_xs[2], t_ys[2] = T_x, min(T_y, T_x - 1)
        value[2, :, t_ys[2]:] = 0.0
    golden = j_reference(value, t_xs, t_ys)
    got = _k6_schedule(value, t_xs, t_ys, max_j)
    np.testing.assert_array_equal(got.astype(np.int32), golden)
    plain = pmas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(t_xs),
                                    torch.from_numpy(t_ys)).numpy()
    np.testing.assert_array_equal(got, plain)
