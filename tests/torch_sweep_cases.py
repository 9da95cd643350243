"""Inputs of the CSM tile-sweep cases shared by ``tests/test_torch_csm.py``
(the plain sweep against the JAX package, on the CPU) and
``tests/test_torch_cuda.py`` (the kernel against the plain sweep, on the
card).  Imports no JAX."""
import numpy as np

TILE_CASES = ["one tile", "block tiles", "strided tile", "off window",
              "strided off window", "masked theta", "300-beam cell",
              "unaligned rows"]


def tile_case(name):
    """NumPy inputs of one tile sweep: (win u8 [N, in_r, in_c, 2], hr, hc
    i32 and ok bool [N, T, B], origins i32 [N, K, 2], (tile_h, tile_w,
    stride), crop).  Beams lie in the crop unless the case says otherwise;
    some sit on the crop's last row and column."""
    rng = np.random.default_rng(TILE_CASES.index(name) + 90)
    N, T, B, crop = 1, 12, 64, 40
    tile, origins = (10, 10, 1), np.zeros((1, 1, 2), np.int32)
    lo, hi = 0, crop
    if name == "block tiles":  # 10 of an 11 x 11 grid of 5 x 5 blocks
        N, B, crop = 2, 96, 48
        b = np.stack([rng.choice(121, 10, replace=False) for _ in range(N)])
        origins = np.stack([b // 11 * 5, b % 11 * 5], -1)
        tile = (5, 5, 1)
    elif name == "strided tile":
        tile = (11, 11, 5)
    elif name in ("off window", "strided off window"):
        N, lo, hi = 2, -3, crop + 3
        origins = np.array([[[-7, -3], [25, 28], [3, -9]],
                            [[-1, 40], [12, 2], [44, -6]]])
        tile = (5, 5, 1) if name == "off window" else (4, 6, 3)
    elif name == "300-beam cell":
        B, T = 320, 6
    elif name == "unaligned rows":  # window width 333: rows not 4-aligned
        T, B, crop = 8, 512, 324
    th, tw, stride = tile
    if name in ("off window", "strided off window"):
        in_r, in_c = crop + 6, crop + 7
    else:
        in_r = crop + int(origins[..., 0].max()) + (th - 1) * stride
        in_c = crop + int(origins[..., 1].max()) + (tw - 1) * stride
    hr = rng.integers(lo, hi, (N, T, B)).astype(np.int32)
    hc = rng.integers(lo, hi, (N, T, B)).astype(np.int32)
    hr[:, :, :4], hc[:, :, 2:6] = crop - 1, crop - 1
    ok = rng.uniform(size=(N, T, B)) < 0.9
    if name == "masked theta":
        ok[:, 3] = False
    if name == "300-beam cell":
        hr[:, :, :300], hc[:, :, :300], ok[:, :, :300] = 11, 13, True
    win = np.stack([rng.integers(0, 256, (N, in_r, in_c)),
                    255 * (rng.uniform(size=(N, in_r, in_c)) < 0.7)],
                   -1).astype(np.uint8)
    return win, hr, hc, ok, origins.astype(np.int32), tile, crop


def f32_window(win_u8, seed, precision="highest"):
    """An f32 window ``[N, in_r, in_c, 2]`` of the shape of the u8 window
    ``win_u8``: probabilities in [1e-3, 1 - 1e-3] (the clamp of
    ``grid/values.py``) where observed, 0 elsewhere, observed as 0/1; the
    probabilities rounded as ``precision`` rounds them (``ops/csm.py:
    round_window``, spelled out here in NumPy through bf16 bits)."""
    rng = np.random.default_rng(seed)
    obs = win_u8[..., 1] > 0
    p = rng.uniform(1e-3, 1 - 1e-3, obs.shape).astype(np.float32)
    if precision != "highest":
        hi = _bf16(p)
        p = hi if precision == "fast" else (hi + _bf16(p - hi)).astype(
            np.float32)
    return np.stack([np.where(obs, p, 0), obs], -1).astype(np.float32)


# Cells below 2^-18, where the sweep rounds a prob to the nearest multiple
# of 2^-41 (ops/csm.py:round_to_fixed_point): 1e-7 and 3e-9 (rounded),
# 2^-40 (a multiple already), ties at 2^-42 and 2.5 * 2^-41 (to even),
# and 3 * 2^-43.
SMALL_CELLS = np.float32([1e-7, 3e-9, 2.0 ** -40, 2.0 ** -42, 2.5 * 2.0 ** -41,
                          3 * 2.0 ** -43])


def small_cell_window(win_u8, seed):
    """An f32 window ``[N, in_r, in_c, 2]`` of the shape of ``win_u8``
    whose observed cells each hold one of :data:`SMALL_CELLS` or, one in
    five, a prob in [1e-3, 1 - 1e-3]; observed as 0/1."""
    rng = np.random.default_rng(seed)
    obs = win_u8[..., 1] > 0
    p = np.where(rng.uniform(size=obs.shape) < 0.2,
                 rng.uniform(1e-3, 1 - 1e-3, obs.shape),
                 SMALL_CELLS[rng.integers(0, len(SMALL_CELLS), obs.shape)])
    return np.stack([np.where(obs, p, 0), obs], -1).astype(np.float32)


def _bf16(x):
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)
