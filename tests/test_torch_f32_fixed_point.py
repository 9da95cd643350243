"""The f32 sweep's fixed-point arithmetic on the CPU, step for step: the
pack's plain version (``ops/csm.py:pack_f32_window_plain``), u64 sums of
at most 128 beams (a warp's: 32 lanes x up to 4 beams), the unpack of
each group's word into the prob sum and the observed count, and one
rounding of ``double(sum m) * 2^-41``.  The result must equal the plain
sweep's f64 sums (``ops/csm.py:sweep_plain``) bit for bit, on every
window: the plain sweep rounds an f32 window's cells to multiples of
2^-41 (``ops/csm.py:round_to_fixed_point``) as the pack does, which
changes no cell from 2^-18 up.

Then every f32 sum site of the port on a map with cells below 2^-18
(1e-7, 3e-9, 2^-40, ties at 2^-42 and 2.5 * 2^-41): the window cut
(``sweep_input_window``) at each precision, ``sweep_windows``,
``sweep_from_hits`` / ``sweep_from_hits_at`` and the grid search's
arbitrary-step gather must each give the exact sum of the rounded cells,
bit for bit, which is what the card's kernel sums (ROADMAP 3.15).

The card's kernel is held to the plain sweep in ``tests/test_torch_cuda.py``;
these tests show the arithmetic it runs is exact, with no card.  The
groups here are 128 consecutive beams where a warp's are strided; the
sums are integers, so the grouping changes nothing but the bound that
each group respects.  Imports no JAX.
"""
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.matching import grid_search
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, quant
from torch_card_cases import (
    SMALL_CELLS,
    f32_window,
    small_cell_window,
    tile_case,
)
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
    precision, u8 levels / 255, the clamp's two ends, all 2^-18, or cells
    below 2^-18 (:func:`torch_card_cases.small_cell_window`)."""
    if kind in ("highest", "fast", "split"):
        return torch.as_tensor(f32_window(win_u8, seed, kind))
    if kind == "below 2^-18":
        return torch.as_tensor(small_cell_window(win_u8, seed))
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
         "2^-18", "below 2^-18"]
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


def test_round_to_fixed_point_is_the_packs_rounding():
    """``round_to_fixed_point`` gives the pack's ``m`` times 2^-41 as an f32
    (ties to even), passes every f32 from 2^-18 up unchanged, is its own
    fixed point, and moves a cell by at most 2^-42."""
    rng = np.random.default_rng(15)
    big = np.concatenate([
        np.float32([2.0 ** -18, 1e-3, 1 - 1e-3, 1.0]),
        (2.0 ** rng.uniform(-18, 0, 4096)).astype(np.float32),
        rng.integers(0, 256, 256).astype(np.float32) / np.float32(255)])
    x = torch.as_tensor(big)
    assert torch.equal(csm.round_to_fixed_point(x), x)
    small = np.concatenate([SMALL_CELLS, (2.0 ** rng.uniform(-60, -18, 4096))
                            .astype(np.float32)])
    win = torch.as_tensor(
        np.stack([small, np.ones_like(small)], -1)[None, None])
    got = csm.round_to_fixed_point(win)
    m = (csm.pack_f32_window_plain(win).numpy().view(np.uint64).ravel()
         & SUM_MASK).astype(np.float64)
    assert got.dtype == torch.float32
    assert np.array_equal(got[..., 0].numpy().ravel().astype(np.float64),
                          m * 2.0 ** -csm.F32_FIXED_BITS)
    assert torch.equal(csm.round_to_fixed_point(got), got)
    d = (got[..., 0].double() - win[..., 0].double()).abs().max()
    assert d <= 2.0 ** -42
    # ties go to the even multiple: 2^-42 -> 0, 2.5 * 2^-41 -> 2 * 2^-41
    t = csm.round_to_fixed_point(torch.tensor([2.0 ** -42, 2.5 * 2.0 ** -41,
                                               1.5 * 2.0 ** -41]))
    assert t.tolist() == [0.0, 2.0 ** -40, 2.0 ** -40]
    u8 = torch.arange(256, dtype=torch.uint8)
    assert csm.round_to_fixed_point(u8) is u8


# ---- every f32 sum site on cells below 2^-18 (ROADMAP 3.15) --------------
H, W, RES = 72, 80, 0.05


def _class_map(seed, mixed):
    """A map of value classes: 0 (unknown), each of ``SMALL_CELLS``, and
    with ``mixed`` two values the package's maps hold.  Returns (class
    index i64 ``[H, W]``, class values f32)."""
    values = np.concatenate([[0.0], SMALL_CELLS]
                            + ([[0.37, 1 - 1e-3]] if mixed else []))
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, len(values), (H, W))),
            torch.as_tensor(values.astype(np.float32)))


def _exact_sums(run, cls, values, precision):
    """The exact sums of the rounded cells that ``run(prob, observed)``
    reads, from integer counts alone: ``run`` with the observed mask on
    one class gives that class's hit count as its known count (exact in
    f32), so the scores are ``sum_k count_k * m_k * 2^-41`` in integers,
    ``m_k`` the class value rounded at ``precision`` and then to the
    nearest multiple of 2^-41 (NumPy's ``rint``: ties to even), rounded
    once to f32.  Returns (that, run's scores, run's known)."""
    prob = values[cls]
    rounded = csm.round_window(values, precision).numpy().astype(np.float64)
    m = np.rint(rounded * 2.0 ** csm.F32_FIXED_BITS).astype(np.int64)
    total = 0
    for k in range(1, len(values)):
        _, count = run(prob, cls == k)
        total = total + count.numpy().astype(np.int64) * m[k]
    scores, known = run(prob, cls != 0)
    want = (total.astype(np.float64) * 2.0 ** -csm.F32_FIXED_BITS).astype(
        np.float32)
    return torch.as_tensor(want), scores, known


def _cells(seed, T=6, B=120, rows=H, cols=W):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, rows, (T, B)).astype(np.int32)),
            torch.as_tensor(rng.integers(0, cols, (T, B)).astype(np.int32)),
            torch.as_tensor(rng.uniform(size=(T, B)) < 0.9))


MAPS = [pytest.param(False, id="small cells"),
        pytest.param(True, id="mixed")]


@pytest.mark.parametrize("mixed", MAPS)
@pytest.mark.parametrize("precision", ["highest", "fast", "split"])
def test_window_cut_sums_are_exact(mixed, precision):
    """``sweep_input_window`` then :func:`csm.sweep` (the CPU's plain
    sweep), at a stride-1 and a strided tile."""
    cls, values = _class_map(31, mixed)
    hr, hc, ok = _cells(32, rows=40, cols=40)
    r0 = torch.tensor(9, dtype=torch.int32)
    c0 = torch.tensor(-3, dtype=torch.int32)
    for th, tw, stride in ((6, 7, 1), (4, 5, 3)):
        in_r, in_c = 40 + (th - 1) * stride, 40 + (tw - 1) * stride

        def run(prob, obs):
            win = csm.sweep_input_window(prob, obs, r0, c0, -2, 1,
                                         in_rows=in_r, in_cols=in_c,
                                         precision=precision)
            origin = torch.zeros((1, 1, 2), dtype=torch.int32)
            out = csm.sweep(win[None].contiguous(), hr[None], hc[None],
                            ok[None], origin, tile_h=th, tile_w=tw,
                            stride=stride)[0]
            return out[:, 0], out[:, 1]

        want, scores, known = _exact_sums(run, cls, values, precision)
        assert torch.equal(scores, want)
        assert known.max() > 0 and scores.max() > 0


@pytest.mark.parametrize("mixed", MAPS)
def test_sweep_windows_sums_are_exact(mixed):
    """``sweep_windows`` over the whole map (the gather backend's sweep),
    one map and a stack of two with ``map_index``."""
    cls, values = _class_map(33, mixed)
    row, col, ok = _cells(34)

    def run(prob, obs):
        return csm.sweep_windows(prob, obs, row, col, ok, -3, -2, ny=5, nx=6,
                                 stride=2)

    want, scores, known = _exact_sums(run, cls, values, "highest")
    assert torch.equal(scores, want) and scores.max() > 0

    def run_stack(prob, obs):
        s, k = csm.sweep_windows(
            torch.stack([prob.flip(0), prob]), torch.stack([obs.flip(0), obs]),
            row[None].expand(2, -1, -1), col[None].expand(2, -1, -1),
            ok[None].expand(2, -1, -1), -3, -2, ny=5, nx=6, stride=2,
            map_index=torch.tensor([1, 0]))
        return s[0], k[0]

    assert torch.equal(_exact_sums(run_stack, cls, values, "highest")[1], want)


@pytest.mark.parametrize("mixed", MAPS)
@pytest.mark.parametrize("precision", ["highest", "split"])
def test_sweep_from_hits_sums_are_exact(mixed, precision):
    """Branch-and-bound's f64 patch products: ``sweep_from_hits`` over a
    strided grid and ``sweep_from_hits_at`` at explicit offsets."""
    cls, values = _class_map(35, mixed)
    hr, hc, ok = _cells(36, rows=32, cols=32)
    img = csm.build_hit_images(hr, hc, ok, torch.ones(6, dtype=torch.bool),
                               crop_rows=32, crop_cols=32)
    r0 = torch.tensor(4, dtype=torch.int32)
    c0 = torch.tensor(11, dtype=torch.int32)
    off = torch.tensor([[0, 0], [3, 7], [9, 2], [12, 12]], dtype=torch.int32)

    def run(prob, obs):
        return csm.sweep_from_hits(img, r0, c0, prob, obs, -1, 2, nx=4, ny=3,
                                   stride=4, precision=precision)

    def run_at(prob, obs):
        return csm.sweep_from_hits_at(img, r0, c0, prob, obs, -1, 2, off,
                                      max_j=12, max_i=12, precision=precision)

    for fn in (run, run_at):
        want, scores, known = _exact_sums(fn, cls, values, precision)
        assert torch.equal(scores, want) and scores.max() > 0


@pytest.mark.parametrize("mixed", MAPS)
def test_grid_search_gather_sums_are_exact(mixed):
    """The grid search at steps that are not the map resolution: each
    candidate's beams gathered from the whole map, summed in f64."""
    cls, values = _class_map(37, mixed)
    rng = np.random.default_rng(38)
    cfg = grid_search.GridSearchConfig(range_x=0.3, range_y=0.2,
                                       range_theta=0.04, step_x=0.07,
                                       step_y=0.03, step_theta=0.01,
                                       resolution=RES)
    assert not cfg.integer_steps
    B = 90
    ranges = torch.as_tensor(rng.uniform(0.3, 1.6, B).astype(np.float32))
    angles = torch.as_tensor(np.linspace(-np.pi, np.pi, B, endpoint=False)
                             .astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=B) < 0.9)
    pose = torch.tensor([1.9, 1.7, 0.3])
    offset = torch.tensor([0.0, 0.0])

    def run(prob, obs):
        return grid_search.pixel_scores_gather(cfg, prob, obs, ranges, angles,
                                               mask, pose, offset)

    want, scores, known = _exact_sums(run, cls, values, "highest")
    assert torch.equal(scores, want) and scores.max() > 0
