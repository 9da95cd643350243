"""Tests of the port that need the card.  They import no JAX (the card's
machine has none) and skip without a GPU.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda, hit_images_cuda
from torch_sweep_cases import (
    TILE_CASES,
    f32_window,
    small_cell_window,
    tile_case,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import or
    collection): without one the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _inputs(rng, N, T, B, crop, in_r, in_c):
    hr = torch.as_tensor(rng.integers(0, crop, (N, T, B)).astype(np.int32))
    hc = torch.as_tensor(rng.integers(0, crop, (N, T, B)).astype(np.int32))
    ok = torch.as_tensor(rng.uniform(size=(N, T, B)) < 0.9)
    win = torch.as_tensor(rng.integers(0, 256, (N, in_r, in_c, 2)).astype(np.uint8))
    return win, hr, hc, ok


@pytest.mark.parametrize("name", TILE_CASES)
def test_tile_kernel_equals_plain(cuda_device, name):
    win, hr, hc, ok, origins, (th, tw, stride), _ = tile_case(name)
    args = [torch.as_tensor(a) for a in (win, hr, hc, ok, origins)]
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    ref = csm.sweep_tiles_plain(*args, **kw)
    before = csm_cuda.LAUNCHES
    out = csm.sweep(*[a.to(cuda_device) for a in args], **kw)
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ref)


# (N, T, B, crop, ny, nx, stride): coarse and fine frontend sweeps, a
# batched odd shape, and a degenerate theta with 300 beams in one cell.
@pytest.mark.parametrize("shape", [
    (1, 208, 512, 320, 2, 2, 5),
    (1, 32, 512, 320, 10, 10, 1),
    (3, 17, 200, 64, 7, 5, 2),
    (1, 8, 512, 320, 10, 10, 1),
])
def test_kernel_equals_plain(cuda_device, shape):
    N, T, B, crop, ny, nx, stride = shape
    rng = np.random.default_rng(sum(shape))
    in_r, in_c = crop + (ny - 1) * stride, crop + (nx - 1) * stride
    win, hr, hc, ok = _inputs(rng, N, T, B, crop, in_r, in_c)
    if T == 8:
        hr[:, :, :300], hc[:, :, :300], ok[:, :, :300] = 11, 13, True
    origins = torch.zeros((N, 1, 2), dtype=torch.int32)
    kw = dict(tile_h=ny, tile_w=nx, stride=stride)
    off = csm.grid_offsets(ny, nx, stride, "cpu").expand(N, -1, -1)
    ref = csm.sweep_plain(win, hr, hc, ok, off)
    before = csm_cuda.LAUNCHES
    out = csm.sweep(*[a.to(cuda_device) for a in (win, hr, hc, ok, origins)],
                    **kw)
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ref)


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(1)
    win, hr, hc, ok = [a.to(cuda_device) for a in _inputs(rng, 1, 4, 64, 32, 36, 36)]
    org = torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda_device)
    kw = dict(tile_h=5, tile_w=5, stride=1)
    before = csm_cuda.LAUNCHES
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.transpose(1, 2).contiguous().transpose(1, 2),
                           hc, ok, org, **kw)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.cpu(), hc, ok, org, **kw)
    with pytest.raises(ValueError):  # one channel: the kernel reads two
        csm_cuda.csm_sweep(win[..., :1].contiguous(), hr, hc, ok, org, **kw)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.long(), hc, ok, org, **kw)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win.float(), hr, hc, ok, org, **kw)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr, hc, ok.to(torch.uint8), org, **kw)
    with pytest.raises(ValueError):  # hr's batch differs from win's
        csm_cuda.csm_sweep(win, torch.cat([hr, hr]), hc, ok, org, **kw)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr, hc, ok, org.long(), **kw)
    with pytest.raises(ValueError):  # read in aligned 8-byte words
        shifted = win.reshape(-1)[2:2 + 2 * 35 * 36].view(1, 35, 36, 2)
        csm_cuda.csm_sweep(shifted, hr, hc, ok, org, **kw)
    for bad in (dict(tile_h=0), dict(tile_w=-1), dict(stride=0),
                dict(tile_w=5.0)):
        with pytest.raises(ValueError):
            csm_cuda.csm_sweep(win, hr, hc, ok, org, **{**kw, **bad})
    for bad_org in (org[:, :0], org[..., :1], org.repeat(2, 1, 1)):
        with pytest.raises(ValueError):
            csm_cuda.csm_sweep(win, hr, hc, ok, bad_org.contiguous(), **kw)
    assert csm_cuda.LAUNCHES == before


@pytest.mark.parametrize("precision", ["highest", "split"])
@pytest.mark.parametrize("name", TILE_CASES)
def test_f32_tile_kernel_equals_plain(cuda_device, name, precision):
    """The f32 kernel at every tile case, on windows rounded as each
    precision rounds them: its exact f64 sums equal the plain version's
    bit for bit, and one launch is counted apart from the u8 kernel's."""
    win, hr, hc, ok, origins, (th, tw, stride), _ = tile_case(name)
    win = f32_window(win, TILE_CASES.index(name), precision)
    args = [torch.as_tensor(a) for a in (win, hr, hc, ok, origins)]
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    ref = csm.sweep_tiles_plain(*args, **kw)
    before, before_u8 = csm_cuda.F32_LAUNCHES, csm_cuda.LAUNCHES
    before_pack = csm_cuda.F32_PACK_LAUNCHES
    out = csm.sweep(*[a.to(cuda_device) for a in args], **kw)
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.F32_LAUNCHES == before + 1
    assert csm_cuda.F32_PACK_LAUNCHES == before_pack + 1
    assert csm_cuda.LAUNCHES == before_u8
    assert torch.equal(out.cpu(), ref)


# (N, T, B, in_r, in_c, ny, nx, stride): the frontend's coarse and fine
# sweeps, the loop batch's, and a whole 1024 x 1024 map as the window
# with beams off it on every side (the gather backend).
@pytest.mark.parametrize("shape", [
    (1, 208, 512, 325, 325, 2, 2, 5),
    (1, 32, 512, 329, 329, 10, 10, 1),
    (8, 32, 512, 502, 502, 5, 5, 1),
    (2, 40, 512, 1024, 1024, 11, 11, 5),
    (2, 40, 512, 1024, 1024, 55, 55, 1),
])
def test_f32_kernel_equals_plain(cuda_device, shape):
    N, T, B, in_r, in_c, ny, nx, stride = shape
    rng = np.random.default_rng(sum(shape))
    win, hr, hc, ok = _inputs(rng, N, T, B, in_r, in_r, in_c)
    hr -= 20
    hc -= 20
    win = torch.as_tensor(f32_window(win.numpy(), sum(shape), "split"))
    origins = torch.as_tensor(
        rng.integers(-25, 5, (N, 1, 2)).astype(np.int32))
    kw = dict(tile_h=ny, tile_w=nx, stride=stride)
    ref = csm.sweep_tiles_plain(win, hr, hc, ok, origins, **kw)
    out = csm.sweep(*[a.to(cuda_device) for a in (win, hr, hc, ok, origins)],
                    **kw)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("tile", [(10, 10, 1), (11, 11, 5)])
def test_f32_kernel_at_2048_beams_all_ones(cuda_device, tile):
    """The edge of the fixed point: 2,048 beams (the most the kernel
    takes), every one valid and every offset on a window of 1.0 observed,
    so each output sums m = 2048 * 2^41 = 2^52 and each warp's observed
    count is 128: 2048.0 in both channels, equal to the plain version."""
    rng = np.random.default_rng(2048)
    N, T, B = 2, 3, 2048
    win = torch.ones((N, 64, 64, 2), dtype=torch.float32)
    hr = torch.as_tensor(rng.integers(0, 10, (N, T, B)).astype(np.int32))
    hc = torch.as_tensor(rng.integers(0, 10, (N, T, B)).astype(np.int32))
    ok = torch.ones((N, T, B), dtype=torch.bool)
    origins = torch.zeros((N, 1, 2), dtype=torch.int32)
    th, tw, stride = tile
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    ref = csm.sweep_tiles_plain(win, hr, hc, ok, origins, **kw)
    out = csm_cuda.csm_sweep_f32(
        *[a.to(cuda_device) for a in (win, hr, hc, ok, origins)], **kw)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(ref, torch.full_like(ref, 2048.0))
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("rounded", [False, True], ids=["raw", "rounded"])
@pytest.mark.parametrize("name", ["one tile", "strided off window",
                                  "300-beam cell", "unaligned rows"])
def test_f32_kernel_equals_plain_below_2_18(cuda_device, name, rounded):
    """A window of cells below 2^-18 (1e-7, 3e-9, 2^-40, ties) among
    ordinary ones (ROADMAP 3.15): the kernel's pack rounds each cell to a
    multiple of 2^-41 as ``ops/csm.py:round_to_fixed_point`` does, and the
    plain sweep rounds its window so, so the two agree bit for bit on the
    window as it is and on one already rounded."""
    win_u8, hr, hc, ok, origins, (th, tw, stride), _ = tile_case(name)
    win = torch.as_tensor(small_cell_window(win_u8, 315))
    if rounded:
        win = csm.round_to_fixed_point(win)
    args = [win] + [torch.as_tensor(a) for a in (hr, hc, ok, origins)]
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    ref = csm.sweep_tiles_plain(*args, **kw)
    before = csm_cuda.F32_LAUNCHES
    out = csm.sweep(*[a.to(cuda_device) for a in args], **kw)
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.F32_LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ref)


# Windows of the pack: the frontend's (an odd number of cells), one of a
# precision's roundings, the clamp's ends with unobserved cells that hold
# a prob, cells below 2^-18 (rounded to the nearest integer), and a
# 1024 x 1024 map pair.
@pytest.mark.parametrize("case", ["split 329", "fast", "ends", "below 2^-18",
                                  "map pair"])
def test_f32_pack_kernel_equals_plain(cuda_device, case):
    rng = np.random.default_rng(len(case))
    shape = {"split 329": (1, 329, 329), "map pair": (2, 1024, 1024)}.get(
        case, (3, 37, 41))
    obs = rng.uniform(size=shape) < 0.7
    p = rng.uniform(1e-3, 1 - 1e-3, shape).astype(np.float32)
    if case == "ends":
        p = np.where(rng.uniform(size=shape) < 0.5, np.float32(1e-3),
                     np.float32(1 - 1e-3))
    elif case == "below 2^-18":
        p = (rng.integers(0, 2 ** 12, shape) * 2.0 ** -52).astype(np.float32)
    win = torch.as_tensor(np.stack(
        [np.where(obs | (case == "ends"), p, 0), obs], -1).astype(np.float32))
    if case in ("split 329", "fast"):
        win = csm.round_window(win, case.split()[0])
    before, before_sweep = csm_cuda.F32_PACK_LAUNCHES, csm_cuda.F32_LAUNCHES
    got = csm_cuda.csm_pack_f32(win.to(cuda_device))
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.F32_PACK_LAUNCHES == before + 1
    assert csm_cuda.F32_LAUNCHES == before_sweep
    assert got.dtype == torch.int64 and got.shape == shape
    assert torch.equal(got.cpu(), csm.pack_f32_window_plain(win))


def test_f32_kernel_raises_on_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(2)
    win, hr, hc, ok = [a.to(cuda_device)
                       for a in _inputs(rng, 1, 4, 64, 32, 36, 36)]
    win = win.float()
    org = torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda_device)
    kw = dict(tile_h=5, tile_w=5, stride=1)
    before = csm_cuda.F32_LAUNCHES, csm_cuda.F32_PACK_LAUNCHES
    for bad in (dict(win=win.double()), dict(win=win.to(torch.uint8)),
                dict(win=win.half()), dict(win=win[..., :1].contiguous()),
                dict(win=win.cpu()), dict(hr=hr.long()),
                dict(ok=ok.to(torch.uint8)), dict(origins=org.long()),
                dict(hr=torch.cat([hr, hr])),
                dict(win=win.reshape(-1)[2:2 + 2 * 35 * 36].view(1, 35, 36, 2)),
                dict(win=win.transpose(1, 2)), dict(tile_h=0),
                dict(stride=0), dict(tile_w=5.0)):
        a = dict(win=win, hr=hr, hc=hc, ok=ok, origins=org, **kw)
        a.update(bad)
        with pytest.raises(ValueError):
            csm_cuda.csm_sweep_f32(**a)
    with pytest.raises(ValueError):  # the u8 kernel refuses f32 windows
        csm_cuda.csm_sweep(win, hr, hc, ok, org, **kw)
    for bad in (win.double(), win[..., :1].contiguous(), win.cpu(),
                win.transpose(1, 2),
                win.reshape(-1)[2:2 + 2 * 35 * 36].view(1, 35, 36, 2)):
        with pytest.raises(ValueError):
            csm_cuda.csm_pack_f32(bad)
    assert (csm_cuda.F32_LAUNCHES, csm_cuda.F32_PACK_LAUNCHES) == before


@pytest.mark.parametrize("backend", ["matmul", "scatter"])
def test_rasterize_adds_are_bitwise_equal_on_cuda_and_cpu(cuda_device,
                                                          backend):
    """``index_add_`` of one f32 value per hit (and per miss sample on the
    scatter backend) lands in another order on the card (atomics), and
    every order gives the same sum: 512 beams ending in 8 cells, deltas
    and an integrated map equal on both devices bit for bit."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import rasterize

    rng = np.random.default_rng(12)
    B, shape, res = 512, (256, 256), 0.05
    targets = rng.uniform(-5, 5, (8, 2))
    hits = (targets[rng.integers(0, 8, (2, B))]
            + rng.uniform(0, 0.01, (2, B, 2))).astype(np.float32)
    sensors = np.float32([[0.11, -0.07], [0.4, 0.3]])
    mask = rng.uniform(size=(2, B)) < 0.95
    off = np.float32([-6.4, -6.4])
    lh, lm = float(np.log(0.62 / 0.38)), float(np.log(0.46 / 0.54))
    kw = dict(num_samples=256, crop=256, backend=backend)

    def run(dev):
        t = [torch.as_tensor(a, device=dev) for a in (sensors, hits, mask, off)]
        delta = rasterize.scan_delta(shape, t[0][0], t[1][0], t[2][0], res,
                                     t[3], lh, lm, **kw)
        lo, obs, n = rasterize.integrate_scans(
            torch.zeros(shape, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev), *t[:3], res,
            t[3], lh, lm, **kw)
        return [a.cpu() for a in (delta, lo, obs, n)]

    for g, c in zip(run(cuda_device), run("cpu")):
        assert torch.equal(g, c)


# (T, B, crop_rows, crop_cols, pile): branch-and-bound's shape, the
# frontend crop, an odd non-square shape, and 300 beams of every theta in
# one cell.
@pytest.mark.parametrize("shape", [
    (208, 512, 448, 448, 0),
    (208, 512, 320, 320, 0),
    (7, 333, 40, 56, 0),
    (16, 512, 64, 64, 300),
])
def test_hit_kernel_equals_plain(cuda_device, shape):
    T, B, CR, CC, pile = shape
    rng = np.random.default_rng(sum(shape))
    rows = rng.integers(-3, CR + 3, (T, B)).astype(np.int32)
    cols = rng.integers(-3, CC + 3, (T, B)).astype(np.int32)
    rows[rng.uniform(size=(T, B)) < 0.05] = -1
    rows[:, :pile], cols[:, :pile] = 5, 7
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    ref = csm.hit_images_plain(rows, cols, crop_rows=CR, crop_cols=CC)
    before = hit_images_cuda.LAUNCHES
    out = csm.hit_images(rows.to(cuda_device), cols.to(cuda_device),
                         crop_rows=CR, crop_cols=CC)
    torch.cuda.synchronize(cuda_device)
    assert hit_images_cuda.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ref)
    if pile:
        assert float(out[:, 5, 7].min()) >= pile


def test_hit_kernel_raises_on_what_it_does_not_take(cuda_device):
    rows = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    kw = dict(crop_rows=8, crop_cols=8)
    before = hit_images_cuda.LAUNCHES
    with pytest.raises(ValueError):  # CPU tensors: no plain fallback here
        hit_images_cuda.hit_images(rows.cpu(), rows.cpu(), **kw)
    with pytest.raises(ValueError):
        hit_images_cuda.hit_images(rows.long(), rows, **kw)
    with pytest.raises(ValueError):
        hit_images_cuda.hit_images(rows, rows[:, :16], **kw)
    with pytest.raises(ValueError):
        hit_images_cuda.hit_images(rows, rows.cpu(), **kw)
    with pytest.raises(ValueError):  # not contiguous
        hit_images_cuda.hit_images(rows.t(), rows.t(), **kw)
    with pytest.raises(ValueError):
        hit_images_cuda.hit_images(rows, rows, crop_rows=0, crop_cols=8)
    assert hit_images_cuda.LAUNCHES == before


def test_sweep_from_hits_cuda_equals_cpu(cuda_device):
    """Branch-and-bound's f32 patch matmul is exact on the card too (TF32
    off): bound and block sweeps equal the CPU's bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    prob = torch.as_tensor(rng.integers(0, 256, (600, 560)).astype(np.uint8))
    obs = torch.as_tensor(rng.uniform(size=(600, 560)) < 0.7)
    # real hit images: at most 512 beams per theta, so every sum < 2^24
    hit = csm.hit_images_plain(
        torch.as_tensor(rng.integers(0, 448, (32, 512)).astype(np.int32)),
        torch.as_tensor(rng.integers(0, 448, (32, 512)).astype(np.int32)),
        crop_rows=448, crop_cols=448)
    r0 = torch.tensor(40, dtype=torch.int32)
    c0 = torch.tensor(30, dtype=torch.int32)
    for nx, ny, stride, x0, y0 in ((13, 13, 8, -50, -50), (8, 8, 1, -18, 6)):
        kw = dict(nx=nx, ny=ny, stride=stride, precision="split")
        ref = csm.sweep_from_hits(hit, r0, c0, prob, obs, x0, y0, **kw)
        got = csm.sweep_from_hits(
            *(a.to(cuda_device) for a in (hit, r0, c0, prob, obs)), x0, y0,
            **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)


def _batched_core_inputs():
    """Three candidates on a stack of two u8 maps (two share map 0), their
    beams, map-local poses, offsets and the full coarse maps."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import pool

    rng = np.random.default_rng(5)
    prob = torch.as_tensor(rng.integers(0, 256, (2, 320, 320)).astype(np.uint8))
    obs = torch.as_tensor(rng.uniform(size=(2, 320, 320)) < 0.8)
    coarse = [pool.sliding_window_max2d(a, 5) for a in (prob, obs)]
    N, B = 3, 192
    angles = np.tile(np.linspace(-2.5, 2.5, B, dtype=np.float32), (N, 1))
    return dict(
        maps=(prob, obs, *coarse),
        beams=(torch.as_tensor(rng.uniform(1, 5, (N, B)).astype(np.float32)),
               torch.as_tensor(angles),
               torch.as_tensor(rng.uniform(size=(N, B)) < 0.9)),
        poses=torch.as_tensor(rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)),
        offsets=torch.full((N, 2), -8.0),
        index=torch.tensor([0, 1, 0]),
    )


def test_batched_core_is_bitwise_equal_on_cuda_and_cpu(cuda_device):
    """The batched loop detector's core (``correlative_core_batch``, one
    coarse and one fine sweep launch for the batch) gives the same bits on
    the card as on the CPU, pruned and dense."""
    from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
        CorrelativeConfig,
        correlative_core_batch,
    )

    cfg = CorrelativeConfig(range_x=1.0, range_y=1.0, range_theta=0.4,
                            n_theta_max=64, crop_rows=256, crop_cols=256,
                            fine_block_b=20)
    x = _batched_core_inputs()
    args = (*x["maps"], *x["beams"], x["poses"], x["offsets"])
    for dense in (False, True):
        ref = correlative_core_batch(cfg, *args, 0.2, 0.1,
                                     map_index=x["index"], dense=dense)
        before = csm_cuda.LAUNCHES
        got = correlative_core_batch(
            cfg, *(a.to(cuda_device) for a in args), 0.2, 0.1,
            map_index=x["index"].to(cuda_device), dense=dense)
        torch.cuda.synchronize(cuda_device)
        assert csm_cuda.LAUNCHES == before + 2
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), r)


def _loop_graph(rng):
    """An over-constrained map/scan graph: noisy intra edges, an inter edge
    per map, loop edges from map 0 to the last scans."""
    M, per_map = 4, 6
    N = M * per_map
    mi = list(np.repeat(np.arange(M), per_map)) + list(range(M - 1)) + [0] * 4
    si = list(range(N)) + [per_map * (m + 1) for m in range(M - 1)] + \
        list(range(N - 4, N))
    il = [0] * (N + M - 1) + [1] * 4
    E = len(mi)
    edges = (np.array(mi, np.int32), np.array(si, np.int32),
             np.array(il, np.int32), rng.normal(0, 0.3, (E, 3)),
             np.tile(np.eye(3) * 100.0, (E, 1, 1)))
    return rng.normal(0, 1, (M, 3)), rng.normal(0, 1, (N, 3)), edges


def test_matching_and_lm_are_bitwise_equal_on_cuda_and_cpu(cuda_device):
    """The f32 math that differs by device (trig, sums over beams, the
    small solves, the LM) runs through ``utils/devmath.py`` or in f64, so
    a match and a pose-graph solve give the same bits on the card and on
    the CPU; without that, CUDA and CPU runs of one sequence drift apart
    (see ``utils/devmath.py``)."""
    from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import (
        OptimizerConfig,
        PoseGraphOptimizer,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import gauss_newton

    rng = np.random.default_rng(3)
    prob = torch.as_tensor(rng.integers(0, 256, (400, 400)).astype(np.uint8))
    obs = torch.as_tensor(rng.uniform(size=(400, 400)) < 0.8)
    ranges = torch.as_tensor(rng.uniform(1, 8, 512).astype(np.float32))
    angles = torch.as_tensor(np.linspace(-3, 3, 512).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=512) < 0.9)
    pose = torch.tensor([0.3, -0.2, 0.1])
    off = torch.tensor([-10.0, -10.0])
    args = (prob, obs, ranges, angles, mask, pose, 0.05, off)
    ref = gauss_newton.gn_refine(*args)
    got = gauss_newton.gn_refine(*(a.to(cuda_device) if torch.is_tensor(a)
                                   else a for a in args))
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    cov = gauss_newton.covariance(*(a.to(cuda_device) if torch.is_tensor(a)
                                    else a for a in args))
    assert torch.equal(cov.cpu(), gauss_newton.covariance(*args))

    mp, sp, edges = _loop_graph(rng)
    for solver in ("dense", "schur"):
        cfg = OptimizerConfig(solver=solver)
        a = PoseGraphOptimizer(cfg, device="cpu").optimize(mp, sp, edges)
        b = PoseGraphOptimizer(cfg, device=cuda_device).optimize(mp, sp, edges)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        # the reported error is an f64 sum rounded to f32 at the end; it
        # may differ in its last f32 bit (the poses above may not)
        assert a[2]["iterations"] == b[2]["iterations"]
        for k in ("error", "initial_error"):
            assert a[2][k] == pytest.approx(b[2][k], rel=2e-7, abs=0)


def _matcher_scene():
    """A u8 map with structure (a random room of wall cells), a scan of
    its walls and a start pose off the truth; beams [B]."""
    rng = np.random.default_rng(9)
    H = W = 320
    obs = np.zeros((H, W), bool)
    obs[40:280, 40:280] = True
    prob = np.where(obs, rng.integers(1, 30, (H, W)), 0).astype(np.uint8)
    for r0, c0, r1, c1 in ((60, 60, 62, 260), (60, 60, 260, 62),
                           (258, 60, 260, 260), (60, 258, 260, 260),
                           (150, 120, 152, 200)):
        prob[r0:r1, c0:c1] = rng.integers(200, 256, (r1 - r0, c1 - c0))
    B = 360
    angles = np.linspace(-np.pi, np.pi, B, endpoint=False).astype(np.float32)
    ranges = rng.uniform(2.0, 5.0, B).astype(np.float32)
    mask = rng.uniform(size=B) < 0.95
    return dict(prob=torch.as_tensor(prob), obs=torch.as_tensor(obs),
                ranges=torch.as_tensor(ranges), angles=torch.as_tensor(angles),
                mask=torch.as_tensor(mask),
                pose=torch.tensor([8.03, 7.96, 0.11]),
                off=torch.tensor([0.013, -0.021]))


@pytest.mark.parametrize("steps", [(0.05, 0.005), (0.03, 0.02)])
def test_grid_search_is_bitwise_equal_on_cuda_and_cpu(cuda_device, steps):
    """The grid-search core gives the same bits on the card as on the CPU:
    integer steps through one sweep launch (T 101, one 51 x 51 tile, crop
    448, the reference's loop window), arbitrary steps through the gather
    core, with SquareError and GreedyEndpoint winner costs."""
    from my_lidar_graph_slam_v2_tpu_torch.matching.cost import CostConfig
    from my_lidar_graph_slam_v2_tpu_torch.matching.grid_search import (
        GridSearchConfig,
        grid_search_core,
    )

    step, step_theta = steps
    x = _matcher_scene()
    args = [x[k] for k in ("prob", "obs", "ranges", "angles", "mask", "pose",
                           "off")]
    for cost in (None, CostConfig(cost_type="GreedyEndpoint")):
        cfg = GridSearchConfig(step_x=step, step_y=step, step_theta=step_theta,
                               cost=cost)
        ref = grid_search_core(cfg, *args, 0.1, 0.2)
        before = csm_cuda.LAUNCHES
        got = grid_search_core(cfg, *(a.to(cuda_device) for a in args),
                               0.1, 0.2)
        torch.cuda.synchronize(cuda_device)
        assert csm_cuda.LAUNCHES == before + int(cfg.integer_steps)
        for g, r in zip(got, ref):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), r)


def test_greedy_endpoint_and_hill_climbing_are_bitwise_equal_on_cuda_and_cpu(
        cuda_device):
    """Greedy-endpoint costs of a batch of poses and the covariance, and a
    whole hill-climbing match, give the same bits on the card."""
    from my_lidar_graph_slam_v2_tpu_torch.matching import cost as pcost
    from my_lidar_graph_slam_v2_tpu_torch.matching.hill_climbing import (
        HillClimbingConfig,
        ScanMatcherHillClimbing,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        MapRaster,
        ScanArrays,
        ScanMatchingQuery,
    )

    x = _matcher_scene()
    ccfg = pcost.CostConfig(cost_type="GreedyEndpoint")
    poses = x["pose"] + torch.as_tensor(
        np.random.default_rng(2).normal(0, 0.05, (6, 3)).astype(np.float32))
    maps = [x[k] for k in ("prob", "obs", "ranges", "angles", "mask")]
    for fn, p in ((pcost.cost_at, poses), (pcost.covariance_at, x["pose"])):
        ref = fn(ccfg, *maps, p, 0.05, x["off"])
        got = fn(ccfg, *(a.to(cuda_device) for a in maps), p.to(cuda_device),
                 0.05, x["off"].to(cuda_device))
        assert torch.equal(got.cpu(), ref)
    out = []
    for dev in ("cpu", cuda_device):
        m = ScanMatcherHillClimbing(HillClimbingConfig(), dev)
        raster = MapRaster(x["prob"].to(dev), x["obs"].to(dev), 0.05,
                           x["off"].numpy().astype(np.float64))
        scan = ScanArrays(x["ranges"].to(dev), x["angles"].to(dev),
                          x["mask"].to(dev), np.zeros(3),
                          int(x["mask"].sum()))
        s = m.optimize_pose(ScanMatchingQuery(
            raster, scan, x["pose"].numpy().astype(np.float64)))
        out.append((s.estimated_pose, s.covariance, s.normalized_cost,
                    m.iterations))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_grid_counted_is_equal_on_cuda_and_cpu(cuda_device):
    from my_lidar_graph_slam_v2_tpu_torch.grid.counted import GridCounted

    rng = np.random.default_rng(4)
    grids = [GridCounted(40, 30, d) for d in ("cpu", cuda_device)]
    for _ in range(3):
        batch = (rng.integers(-3, 43, 2000), rng.integers(-3, 33, 2000),
                 rng.random(2000) > 0.4, rng.random(2000) > 0.1)
        for g in grids:
            g.update(*batch)
    a, b = grids
    for fn in ("prob", "values_u8"):
        assert torch.equal(getattr(b, fn)().cpu(), getattr(a, fn)())
    assert torch.equal(b.values_u16().to(torch.int32).cpu(),
                       a.values_u16().to(torch.int32))
    assert torch.equal(b.counts.cpu(), a.counts)


def test_distributed_lm_is_bitwise_equal_on_cuda_and_cpu(cuda_device):
    """The distributed Schur LM on 1 and 4 edge shards on the card gives
    the CPU's poses bit for bit, and the single-device LM's."""
    from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import (
        PoseGraphOptimizer,
    )
    from my_lidar_graph_slam_v2_tpu_torch.parallel.distributed import (
        DistributedPoseGraphOptimizer,
    )

    mp, sp, edges = _loop_graph(np.random.default_rng(3))
    want = PoseGraphOptimizer(device="cpu").optimize(mp, sp, edges)
    for n in (1, 4):
        for dev in ("cpu", cuda_device):
            got = DistributedPoseGraphOptimizer((dev,) * n).optimize(
                mp, sp, edges)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2]["iterations"] == want[2]["iterations"]


def _mesh_detector_queries(device):
    """Three loop queries on two u8 maps (``_matcher_scene``'s room and
    the same room shifted), their map-local nodes and scans, with the maps
    on ``device``."""
    from my_lidar_graph_slam_v2_tpu_torch import reference
    from my_lidar_graph_slam_v2_tpu_torch.graph.pose_graph import (
        LocalMapNode,
        ScanNode,
    )
    from my_lidar_graph_slam_v2_tpu_torch.sensor.data import ScanData

    x = _matcher_scene()
    prob, obs = x["prob"].numpy(), x["obs"].numpy()
    maps = [reference.local_map(m, x["off"].numpy() - 0.3 * m, device,
                                observed=obs, prob_q=np.roll(prob, 7 * m, 1))
            for m in range(2)]
    rng = np.random.default_rng(6)
    queries = []
    for k, m in enumerate((0, 1, 0)):
        angles = np.sort(rng.uniform(-np.pi, np.pi, 300))
        scan = ScanData("S", 0.0, np.zeros(3), np.zeros(3), np.zeros(3),
                        0.0, 12.0, float(angles[0]), float(angles[-1]),
                        angles, rng.uniform(2.0, 5.0, 300))
        pose = np.array([8.0 + 0.1 * k, 7.9, 0.1 - 0.05 * k])
        queries.append(dict(
            query_node=ScanNode(k, m, np.zeros(3), pose, scan),
            local_map=maps[m],
            local_map_node=LocalMapNode(m, np.zeros(3), True)))
    return queries


def _mesh_detector_match(mesh, device):
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
        LoopDetectorConfig,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
        CorrelativeConfig,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
        LinearSolverConfig,
        ScanMatcherLinearSolver,
    )
    from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
        LoopDetectorShardedCorrelative,
    )

    det = LoopDetectorShardedCorrelative(
        LoopDetectorConfig(score_threshold=0.1, known_rate_threshold=0.1,
                           beam_capacity=512),
        CorrelativeConfig(range_x=1.0, range_y=1.0, range_theta=0.4,
                          n_theta_max=64, crop_rows=256, crop_cols=256),
        ScanMatcherLinearSolver(LinearSolverConfig(), device), mesh)
    before = csm_cuda.LAUNCHES
    out = det.match(_mesh_detector_queries(device))
    return ([(p, s, f) for _, _, p, s, f in out], csm_cuda.LAUNCHES - before,
            det)


def test_mesh_detector_on_one_device_equals_the_batched_detector(
        cuda_device):
    """The batched detector given a device and given a one-device mesh
    make the same two sweep launches (plus two per dense re-run) and the
    CPU's results bit for bit; a two-device mesh of the same card splits
    the step into two chunks, two launches each, with the same results."""
    want, _, _ = _mesh_detector_match("cpu", "cpu")
    for mesh, chunks in ((cuda_device, 1), ((cuda_device,), 1),
                         ((cuda_device, cuda_device), 2)):
        got, launches, det = _mesh_detector_match(mesh, cuda_device)
        assert launches == 2 * chunks + 2 * det.dense_reruns
        assert det.host_fetches == 1 + det.dense_reruns
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]


def test_bench_csm_batch_equals_the_cpu(cuda_device):
    """``scripts/bench_csm.py``'s device part at batch 8: the card's
    outputs equal the CPU's (plain sweep) bit for bit, poses included
    (ROADMAP's device-independent math), with one coarse and one fine
    sweep launch per call."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import bench_csm

    cases = bench_csm.build_workload()
    _, _, cpu = bench_csm.bench_device(cases, iters=1, device="cpu",
                                       with_stages=False)
    before = csm_cuda.LAUNCHES
    _, _, gpu = bench_csm.bench_device(cases, iters=1, device=cuda_device,
                                       with_stages=False)
    assert csm_cuda.LAUNCHES == before + 4  # a warm-up call and a timed one
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.cpu(), c)
