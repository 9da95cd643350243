"""The f32 sweep kernel's fixed-point arithmetic on the CPU, step for step:
the pack's plain version (``ops/csm.py:pack_f32_window_plain``), u64 sums
of at most 128 beams (a warp's: 32 lanes x up to 4 beams), the unpack of
each group's word into the prob sum and the observed count, and one
rounding of ``double(sum m) * 2^-41``.  The result must equal the plain
sweep's f64 sums (``ops/csm.py:sweep_plain``) bit for bit, on every window
the guarantee covers (``csrc/csm_sweep_f32.cu``'s source note).

The card's kernel is held to the plain sweep in ``tests/test_torch_cuda.py``;
these tests show the arithmetic it runs is exact, with no card.  The
groups here are 128 consecutive beams where a warp's are strided; the
sums are integers, so the grouping changes nothing but the bound that
each group respects.  Imports no JAX.
"""
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.ops import csm, quant
from torch_sweep_cases import f32_window, tile_case
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WARP_BEAMS = 128  # 32 lanes x kMaxBeamsPerThread
SUM_MASK = np.uint64((1 << csm.F32_OBS_SHIFT) - 1)


def fixed_point_sweep(win, hr, hc, ok, off, group=WARP_BEAMS):
    """The kernel's arithmetic in NumPy u64 (which wraps as the card's
    adds do): packed cells gathered at ``[hr + oj, hc + oi]`` (0 for masked
    beams and cells off the window), summed per ``group`` beams, each
    group's word unpacked, the parts summed, the prob sum rounded once.
    Shapes as ``csm.sweep_plain``; returns f32 ``[N, T, 2, n_off]``."""
    packed = csm.pack_f32_window_plain(win).numpy().view(np.uint64)
    N, in_r, in_c = packed.shape
    flat = np.concatenate([packed.reshape(N, -1),
                           np.zeros((N, 1), np.uint64)], -1)
    hr, hc, ok, off = (np.asarray(a) for a in (hr, hc, ok, off))
    r = hr[:, :, None, :] + off[:, None, :, 0, None]  # [N, T, n_off, B]
    c = hc[:, :, None, :] + off[:, None, :, 1, None]
    inb = ok[:, :, None, :] & (r >= 0) & (r < in_r) & (c >= 0) & (c < in_c)
    idx = np.where(inb, r * in_c + c, in_r * in_c)
    cells = flat[np.arange(N)[:, None, None, None], idx]
    B = cells.shape[-1]
    pad = -B % group
    cells = np.concatenate(
        [cells, np.zeros(cells.shape[:-1] + (pad,), np.uint64)], -1)
    words = cells.reshape(cells.shape[:-1] + (-1, group)).sum(
        -1, dtype=np.uint64)
    m = (words & SUM_MASK).sum(-1, dtype=np.uint64)
    obs = (words >> np.uint64(csm.F32_OBS_SHIFT)).sum(-1, dtype=np.uint64)
    assert m.max(initial=0) <= 2 ** 52  # exact in an f64
    score = (m.astype(np.float64) * 2.0 ** -csm.F32_FIXED_BITS).astype(
        np.float32)
    return torch.as_tensor(np.stack([score, obs.astype(np.float32)], 2))


def _window(kind, win_u8, seed):
    """An f32 window of ``kind`` where ``win_u8`` is observed (0
    elsewhere): probabilities uniform in [1e-3, 1 - 1e-3] rounded at a
    precision, u8 levels / 255, the clamp's two ends, or all 2^-18."""
    if kind in ("highest", "fast", "split"):
        return torch.as_tensor(f32_window(win_u8, seed, kind))
    obs = torch.as_tensor(win_u8[..., 1] > 0)
    if kind == "u8 levels / 255":
        p = quant.dequant_prob(torch.as_tensor(win_u8[..., 0]))
    elif kind == "clamp ends":
        rng = np.random.default_rng(seed)
        p = torch.as_tensor(np.where(rng.uniform(size=obs.shape) < 0.5,
                                     np.float32(1e-3), np.float32(1 - 1e-3)))
    else:
        p = torch.full(obs.shape, 2.0 ** -18)
    return torch.stack([torch.where(obs, p.to(torch.float32), 0.0),
                        obs.to(torch.float32)], -1)


KINDS = ["highest", "fast", "split", "u8 levels / 255", "clamp ends",
         "2^-18"]
CASES = ["one tile", "strided off window", "300-beam cell"]


def _cases():
    for kind in KINDS:
        for name in CASES:
            yield pytest.param(kind, name, id=f"{kind}-{name}")
    yield pytest.param("2048 beams all 1.0", None, id="2048 beams all 1.0")


@pytest.mark.parametrize("kind,name", list(_cases()))
def test_fixed_point_sums_equal_the_plain_sweep(kind, name):
    if name is None:
        # 2,048 beams (kMaxBeams), every one valid, on a window of 1.0
        # observed everywhere: sum m = 2048 * 2^41 = 2^52, every group's
        # observed count 128 (2^63 of its word).
        N, T, B = 1, 3, 2048
        win = torch.ones((N, 16, 16, 2), dtype=torch.float32)
        hr = torch.full((N, T, B), 3, dtype=torch.int32)
        hc = torch.full((N, T, B), 4, dtype=torch.int32)
        ok = torch.ones((N, T, B), dtype=torch.bool)
        origins = torch.zeros((N, 1, 2), dtype=torch.int32)
        tile = (5, 5, 1)
    else:
        win_u8, hr, hc, ok, origins, tile, _ = (
            torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in tile_case(name))
        win = _window(kind, win_u8.numpy(), KINDS.index(kind) + 7)
    th, tw, stride = tile
    off = csm.tile_offsets(origins, tile_h=th, tile_w=tw, stride=stride)
    ref = csm.sweep_plain(win, hr, hc, ok, off)
    got = fixed_point_sweep(win, hr, hc, ok, off)
    assert torch.equal(got, ref)
    if name is None:
        assert torch.equal(ref, torch.full_like(ref, 2048.0))


def test_observed_count_never_carries_at_128_beams_per_warp():
    """A warp's word holds sum m below bit 56 and the observed count
    above it.  At the most a warp adds, 128 cells of 1.0 observed, the
    word is 2^48 + 128 * 2^56 < 2^64 and unpacks to both exactly; at 256
    cells the count would wrap to 0, which is why a thread takes at most
    4 beams."""
    cell = csm.pack_f32_window_plain(
        torch.ones((1, 1, 1, 2), dtype=torch.float32)).numpy().view(np.uint64)
    assert cell.item() == 2 ** 41 | 2 ** 56
    for beams, want_obs in ((WARP_BEAMS, WARP_BEAMS), (256, 0)):
        word = np.full(beams, cell.item(), np.uint64).sum(dtype=np.uint64)
        assert int(word & SUM_MASK) == beams * 2 ** 41
        assert int(word >> np.uint64(56)) == want_obs


def test_pack_rounds_cells_below_the_guarantee():
    """Probabilities from 2^-18 up are whole multiples of 2^-41 and pack
    exactly; below it the pack rounds ``p * 2^41`` to the nearest integer,
    ties to even (what the kernel's ``__float2ull_rn`` does), and the
    observed flag is ``observed != 0``."""
    p = np.float32([0.0, 2.0 ** -18, 1 - 1e-3, 1.0, 2.0 ** -42, 3 * 2.0 ** -42,
                    5 * 2.0 ** -42, 2.0 ** -41, 2.0 ** -30 * 1.25])
    obs = np.float32([0, 1, 1, 1, 1, 0, 1, 1, 1])
    win = torch.as_tensor(np.stack([p, obs], -1)[None, None])
    got = csm.pack_f32_window_plain(win).numpy().view(np.uint64).ravel()
    want = [round(float(v) * 2.0 ** 41) | (int(o) << 56)
            for v, o in zip(p, obs)]
    assert [int(x) for x in got] == want
    assert want[4] & SUM_MASK == 0 and want[5] & SUM_MASK == 2
    assert want[6] & SUM_MASK == 2 and want[8] & SUM_MASK == 2 ** 11 * 1.25
    exact = p >= 2.0 ** -18
    m = (got & SUM_MASK).astype(np.float64) * 2.0 ** -41
    assert np.array_equal(m[exact], p[exact].astype(np.float64))
