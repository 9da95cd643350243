"""Correlative scan matching (CSM) sweep.

Port of ``my_lidar_graph_slam_v2_tpu/ops/csm.py``.  The JAX package
scores the pose window with one-hot hit images and matmuls on the MXU
(``build_hit_images`` + ``sweep_from_hits`` / ``sweep_from_hits_int8`` /
``sweep_from_hits_at``), or by per-beam window gathers
(``sweep_windows``).  Here the same sums are taken straight from the
per-(theta, beam) endpoint cells::

    S[n, t, ch, o] = sum_b ok[n,t,b] * win[n, hr[n,t,b] + oj[o], hc[n,t,b] + oi[o], ch]

with ``win`` the window cut by :func:`sweep_input_window`, its two
channels interleaved in one cell.  Two window types:

- u8 (a u8 map at any precision but ``"highest"``): prob level and
  observed * 255; ``out = float32(S) * float32(1/255)``.  The XLA forms
  compute exactly these integers (their accumulation is exact below
  2^24), so the scores are bit-identical.
- f32 (an f32 map, or ``precision="highest"``): prob and observed as
  0/1, the prob rounded once as the JAX package's contraction rounds its
  operand (:func:`round_window`), then, where its cells are summed, to
  the nearest multiple of 2^-41 (:func:`round_to_fixed_point` in the
  plain sweep and the hit-image product, the kernel's pack on the card);
  S is summed in f64 and rounded to f32 once.  The sums of at most 2048
  multiples of 2^-41 (each <= 1) stay below 2^52 of those units, so the
  f64 sums are exact in any order: the kernel (which sums the same values
  as integers, :func:`pack_f32_window_plain`), its plain version and
  either device give the same bits, for every window.  Every f32 value
  >= 2^-18 is already such a multiple, so the second rounding changes no
  cell of any map the package builds (sigmoid of log-odds clamped to
  [1e-3, 1 - 1e-3], levels / 255, their bf16 roundings); below 2^-18 it
  moves a cell by at most 2^-42.  The JAX package rounds each f32 add
  instead, so f32 scores agree with it to a few ulps of the score (the
  tests: 2e-3), and known counts exactly.

The offsets are rectangular tiles: the strided coarse grid and the dense
fine grid are one tile each, the block-pruned fine sweep is one 5x5 tile
per selected block (:func:`tile_offsets` spells them out).

:func:`sweep` is the entry point: CPU tensors take :func:`sweep_tiles_plain`,
CUDA tensors launch the hand-written kernel of the window's type
(``ops/csm_cuda.py``).  :func:`sweep_windows` is the same sweep with the
whole map as the window (no crop: every beam scores, cells off the map
read 0), :func:`csm_sweep` the one-call form (beam cells, window, sweep).

Branch-and-bound keeps the JAX package's two-step form: it builds the hit
images once per match (:func:`build_hit_images`; on CUDA tensors the
hand-written kernel of ``ops/hit_images_cuda.py``) and shares them
between its bound sweep and every block sweep (:func:`sweep_from_hits`, a
matmul against the map patches: f32 on u8 maps, f64 on f32 windows, exact
either way).  A batch of candidates builds its images in one call
(:func:`build_hit_images_batch`) and sweeps any number of windows of them
in one call (:func:`sweep_from_hits_batch`), with the same sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import devmath
from ..utils.transfer import f32
from . import csm_cuda, hit_images_cuda, quant


def theta_search_params(ranges, beam_mask, resolution, range_theta, n_theta):
    """Search step and window in theta (``scan_matcher_correlative.cpp:
    255-274``): ``step = 2 asin(0.5 res / max_range)``, ``win =
    ceil(0.5 range_theta / step)``.  Beams ``[..., B]``, one set per
    candidate along the leading axes.  Returns (step_theta f32 ``[...]``,
    theta0_index i32 ``[...]``, theta_mask bool ``[..., n_theta]``), all on
    the scan's device."""
    dev = ranges.device
    max_range = torch.where(beam_mask, ranges, 0.0).amax(dim=-1)
    tt = torch.div(f32(resolution, dev), max_range)
    step_theta = 2.0 * devmath.asin(0.5 * tt)
    win_t = torch.ceil(torch.div(f32(0.5 * range_theta, dev), step_theta))
    win_t = win_t.to(torch.int32)
    half = n_theta // 2
    theta0_index = -torch.clamp(win_t, max=half)
    t_idx = theta0_index[..., None] + torch.arange(
        n_theta, dtype=torch.int32, device=dev)
    theta_mask = (t_idx >= -win_t[..., None]) & (t_idx <= win_t[..., None])
    return step_theta, theta0_index, theta_mask


def beam_cells(
    ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
    theta_mask, resolution, offset_xy, *, n_theta, crop_rows, crop_cols,
):
    """Per-(theta, beam) endpoint cells in crop coordinates, for beams
    ``[..., B]``, poses ``[..., 3]`` and offsets ``[..., 2]`` with the
    leading axes one per candidate (none for a single scan).

    Returns (hr, hc, valid, r0, c0): ``[..., T, B]`` i32 crop coords,
    validity (beam mask and inside the crop), and the crop anchor in
    full-map cell coordinates (i32 ``[...]``)."""
    dev = ranges.device
    res = f32(resolution, dev)
    t_idx = theta0_index[..., None] + torch.arange(
        n_theta, dtype=torch.int32, device=dev)
    thetas = (sensor_pose[..., 2, None]
              + t_idx.to(torch.float32) * step_theta[..., None])
    ang = thetas[..., :, None] + angles[..., None, :]
    rng = ranges[..., None, :]
    hx = sensor_pose[..., 0, None, None] + rng * devmath.cos(ang)
    hy = sensor_pose[..., 1, None, None] + rng * devmath.sin(ang)
    col = torch.floor(torch.div(hx - offset_xy[..., 0, None, None], res))
    row = torch.floor(torch.div(hy - offset_xy[..., 1, None, None], res))
    col, row = col.to(torch.int32), row.to(torch.int32)

    # Crop anchor over valid (beam, theta) pairs only, a touch early so
    # floor rounding never clips the first beam.
    big = 1 << 30
    bbox_mask = beam_mask[..., None, :] & theta_mask[..., :, None]
    r0 = torch.where(bbox_mask, row, big).amin(dim=(-2, -1)) - 2
    c0 = torch.where(bbox_mask, col, big).amin(dim=(-2, -1)) - 2

    hr = row - r0[..., None, None]
    hc = col - c0[..., None, None]
    valid = (
        beam_mask[..., None, :]
        & (hr >= 0) & (hr < crop_rows)
        & (hc >= 0) & (hc < crop_cols)
    )
    return hr, hc, valid, r0, c0


def beam_cells_abs(
    ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
    theta_mask, resolution, offset_xy, *, n_theta,
):
    """Per-(theta, beam) endpoint cells in MAP cell coordinates, for
    beams ``[..., B]`` with leading candidate axes as :func:`beam_cells`.
    Unlike :func:`beam_cells` there is no crop: every valid beam takes
    part (the reference reads unknown off the map,
    ``score_function_pixel_accurate.cpp:16-58``).  Returns ``(row, col,
    ok)`` ``[..., T, B]``, ``ok`` folding beam validity and theta-window
    membership."""
    dev = ranges.device
    res = f32(resolution, dev)
    t_idx = theta0_index[..., None] + torch.arange(
        n_theta, dtype=torch.int32, device=dev)
    thetas = (sensor_pose[..., 2, None]
              + t_idx.to(torch.float32) * step_theta[..., None])
    ang = thetas[..., :, None] + angles[..., None, :]
    rng = ranges[..., None, :]
    hx = sensor_pose[..., 0, None, None] + rng * devmath.cos(ang)
    hy = sensor_pose[..., 1, None, None] + rng * devmath.sin(ang)
    col = torch.floor(torch.div(hx - offset_xy[..., 0, None, None], res))
    row = torch.floor(torch.div(hy - offset_xy[..., 1, None, None], res))
    ok = beam_mask[..., None, :] & theta_mask[..., :, None]
    return row.to(torch.int32), col.to(torch.int32), ok


PRECISIONS = ("fast", "split", "highest")


def check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


def u8_exact(prob, precision) -> bool:
    """Whether a map sweeps as a u8 window (the JAX package's rule: a u8
    map at any precision but ``"highest"``); otherwise the window is
    f32."""
    check_precision(precision)
    return prob.dtype == torch.uint8 and precision != "highest"


def round_window(win, precision):
    """An f32 window rounded once as the JAX package's contraction rounds
    its operand (``ops/csm.py:297-317``): ``"highest"`` as is, ``"fast"``
    ``f32(bf16(v))``, ``"split"`` ``hi + f32(bf16(v - hi))`` with ``hi =
    f32(bf16(v))``; the split's sum is exact in f32 (both parts' bits lie
    within v's significand), so the exact sweep of the rounded window is
    the sum of the JAX package's two partial sums.  u8 windows pass
    through."""
    check_precision(precision)
    if win.dtype == torch.uint8 or precision == "highest":
        return win
    hi = win.to(torch.bfloat16).to(torch.float32)
    if precision == "fast":
        return hi
    return hi + (win - hi).to(torch.bfloat16).to(torch.float32)


def map_planes(prob, observed, idx, inside=None, *, as_f32=False):
    """The map's sweep cells at ``idx`` (an index tuple into the map or
    map stack), interleaved ``[..., 2]``: for a u8 map the prob level and
    observed * 255 (u8), for an f32 map or with ``as_f32`` the prob
    (dequantized) and observed as 0/1 (f32, unrounded); zero where
    ``inside`` is False."""
    ok = observed[idx] if inside is None else inside & observed[idx]
    if prob.dtype == torch.uint8 and not as_f32:
        p = prob[idx] if inside is None else torch.where(inside, prob[idx], 0)
        return torch.stack([p, torch.where(ok, 255, 0).to(torch.uint8)], -1)
    p = quant.dequant_prob(prob[idx])
    if inside is not None:
        p = torch.where(inside, p, 0.0)
    return torch.stack([p, ok.to(torch.float32)], -1)


def sweep_input_window(prob, observed, r0, c0, x0, y0, *, in_rows, in_cols,
                       precision="split", map_index=None):
    """The ``[..., in_rows, in_cols, 2]`` window the sweep correlates
    against, channels interleaved: ``win[r, c, :] = map[r0+y0+r,
    c0+x0+c]`` with zeros outside the raster, one window per anchor
    ``r0``, ``c0`` (``[...]``).  u8 (prob level, observed * 255) when
    :func:`u8_exact`, else f32 (prob dequantized, observed as 0/1) rounded
    by :func:`round_window`.  An unknown precision raises ``ValueError``.

    The maps are one raster ``[H, W]`` shared by every anchor, or a stack
    of a step's distinct rasters ``[M, H, W]`` with ``map_index`` (i64
    ``[N]``) naming each candidate's raster.  The window start follows
    ``jax.lax.dynamic_slice`` into the map padded by ``max(in_rows,
    in_cols)`` on every side: a start that would run off the padded plane
    is clamped so the window fits.  The cut is a gather with device-side
    indices, so no anchor value goes to the host."""
    exact = u8_exact(prob, precision)
    H, W = prob.shape[-2:]
    dev = prob.device
    pad = max(in_rows, in_cols)
    start_r = torch.clamp(r0 + y0 + pad, 0, H + 2 * pad - in_rows) - pad
    start_c = torch.clamp(c0 + x0 + pad, 0, W + 2 * pad - in_cols) - pad
    rr = start_r[..., None] + torch.arange(in_rows, dtype=torch.int32,
                                           device=dev)
    cc = start_c[..., None] + torch.arange(in_cols, dtype=torch.int32,
                                           device=dev)
    inside = (((rr >= 0) & (rr < H))[..., :, None]
              & ((cc >= 0) & (cc < W))[..., None, :])
    rs = torch.clamp(rr, 0, H - 1).long()[..., :, None]
    cs = torch.clamp(cc, 0, W - 1).long()[..., None, :]
    idx = (rs, cs) if map_index is None else (map_index[:, None, None], rs, cs)
    return round_window(map_planes(prob, observed, idx, inside,
                                   as_f32=not exact), precision)


def max_hit_multiplicity(hr, hc, ok, *, crop_cols):
    """Max number of beams sharing one hit cell at any theta (``[...]``
    for cells ``[..., T, B]``).  The JAX package's int8 sweep wraps above
    127 and folds this certificate into the matcher's ``exact`` flag; the
    port's sums never wrap but keep the certificate so ``exact`` and the
    dense re-runs match the reference."""
    B = hr.shape[-1]
    uniq = -1 - torch.arange(B, dtype=torch.int32, device=hr.device)
    key = torch.where(ok, hr * crop_cols + hc, uniq)
    skey = torch.sort(key, dim=-1).values
    same = skey[..., 1:] == skey[..., :-1]
    idx = torch.arange(1, B, dtype=torch.int32, device=hr.device)
    last_break = torch.cummax(torch.where(same, 0, idx), dim=-1).values
    run = torch.where(same, idx - last_break, 0)
    return run.amax(dim=(-2, -1)) + 1


def grid_offsets(ny, nx, stride, device) -> torch.Tensor:
    """i32 ``[ny * nx, 2]`` offsets ``(j * stride, i * stride)``, j-major,
    so a sweep's ``[..., n_off]`` output reshapes to ``[..., ny, nx]``."""
    j = torch.arange(ny, dtype=torch.int32, device=device) * stride
    i = torch.arange(nx, dtype=torch.int32, device=device) * stride
    return torch.stack(
        [j.repeat_interleave(nx), i.repeat(ny)], dim=-1
    ).contiguous()


# Gather elements per chunk of the plain sweep (bounds its transient
# index tensors to a few hundred MB at the loop-detector shape); f32
# windows gather f64 values, so half as many.
_PLAIN_CHUNK = 1 << 25
_PLAIN_CHUNK_F64 = 1 << 24


def sweep_plain(win, hr, hc, ok, off, scale=quant.INV255):
    """Plain PyTorch form of the sweep at explicit offsets: gather ``win``
    at ``[hr + oj, hc + oi]`` (masked beams and cells off the window read
    a zero cell) and sum over beams: a u8 window in int32, then one f32
    multiply by ``scale``; an f32 window rounded by
    :func:`round_to_fixed_point` (as the kernel's pack rounds it), summed
    in f64, then one rounding to f32 (no scale; exact, see the module
    docstring).

    Shapes: win u8 or f32 ``[N, in_r, in_c, 2]``; hr, hc i32 and ok bool
    ``[N, T, B]``; off i32 ``[N, n_off, 2]``, per candidate.  Returns f32
    ``[N, T, 2, n_off]``."""
    N, in_r, in_c, _ = win.shape
    T, B = hr.shape[1], hr.shape[2]
    L = in_r * in_c
    acc = torch.int32 if win.dtype == torch.uint8 else torch.float64
    flat = torch.cat(
        [round_to_fixed_point(win).reshape(N, L, 2).transpose(1, 2).to(acc),
         torch.zeros((N, 2, 1), dtype=acc, device=win.device)],
        dim=-1,
    )
    chunk = _PLAIN_CHUNK if acc == torch.int32 else _PLAIN_CHUNK_F64
    step = max(1, chunk // (N * T * B * 2))
    parts = []
    for o0 in range(0, off.shape[1], step):
        oj = off[:, o0:o0 + step, 0, None, None].transpose(1, 2)  # [., 1, o, 1]
        oi = off[:, o0:o0 + step, 1, None, None].transpose(1, 2)
        r = hr[:, :, None, :] + oj  # [N, T, o, B]
        c = hc[:, :, None, :] + oi
        inb = ok[:, :, None, :] & (r >= 0) & (r < in_r) & (c >= 0) & (c < in_c)
        idx = torch.where(inb, r * in_c + c, L).long()
        g = torch.gather(flat, 2, idx.reshape(N, 1, -1).expand(N, 2, -1))
        parts.append(g.reshape(N, 2, T, -1, B).sum(-1, dtype=acc))
    S = torch.cat(parts, dim=-1).permute(0, 2, 1, 3)
    if acc == torch.float64:
        return S.to(torch.float32)
    return S.to(torch.float32) * float(scale)


# The f32 sweep kernel's fixed point: a prob p is the integer p * 2^41,
# and the observed flag rides above bit 56 of the same u64.
F32_FIXED_BITS = 41
F32_OBS_SHIFT = 56


def pack_f32_window_plain(win):
    """Plain PyTorch form of the f32 sweep kernel's pack: each cell of an
    f32 window ``[N, in_r, in_c, 2]`` as one u64 ``m | obs << 56``, held
    in an i64 ``[N, in_r, in_c]``: ``m = p * 2^41`` rounded to an integer
    (to nearest, ties to even; exact for p = 0 or in [2^-18, 1], where the
    sweep's sums are exact) and ``obs = observed != 0``."""
    m = torch.round(win[..., 0].to(torch.float64) * 2.0 ** F32_FIXED_BITS)
    return (m.to(torch.int64)
            | (win[..., 1] != 0).to(torch.int64) << F32_OBS_SHIFT)


def round_to_fixed_point(x):
    """``x`` (f32) rounded to the nearest multiple of 2^-41, ties to even,
    as the f32 sweep kernel's pack rounds ``p * 2^41``
    (``__float2ull_rn``): the result stays f32 and every sum of at most
    2048 such values in [0, 1] is exact in f64, in any order.  Every f32
    value from 2^-18 up is already a multiple of 2^-41 and passes
    unchanged; below 2^-17 the multiples have fewer than 24 significant
    bits, so the rounding is exact in f32 (scaling by a power of two is
    exact too).  u8 windows pass through."""
    if x.dtype == torch.uint8:
        return x
    return torch.round(x * 2.0 ** F32_FIXED_BITS) * 2.0 ** -F32_FIXED_BITS


def tile_offsets(origins, *, tile_h, tile_w, stride):
    """The explicit offsets of tiles: i32 ``[N, K * tile_h * tile_w, 2]``,
    offset ``(k * tile_h + j) * tile_w + i`` at ``origins[n, k] + (j, i) *
    stride``."""
    grid = grid_offsets(tile_h, tile_w, stride, origins.device)
    return (origins[:, :, None, :] + grid).reshape(origins.shape[0], -1, 2)


def sweep_tiles_plain(win, hr, hc, ok, origins, *, tile_h, tile_w, stride,
                      scale=quant.INV255):
    """Plain PyTorch form of the tile sweep: :func:`sweep_plain` at the
    tiles' explicit offsets (:func:`tile_offsets`)."""
    off = tile_offsets(origins, tile_h=tile_h, tile_w=tile_w, stride=stride)
    return sweep_plain(win, hr, hc, ok, off, scale=scale)


def sweep(win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
    """The CSM sweep over tiles of offsets, f32 ``[N, T, 2, K * tile_h *
    tile_w]`` (scores, known): win u8 or f32 ``[N, in_r, in_c, 2]``, beams
    ``[N, T, B]``, tile origins i32 ``[N, K, 2]`` (see
    ``ops/csm_cuda.py``).  CPU tensors take :func:`sweep_tiles_plain`;
    anything else goes to the wrapper of the window type's kernel, which
    launches on CUDA tensors and raises on anything it does not take."""
    kw = dict(tile_h=tile_h, tile_w=tile_w, stride=stride)
    if win.device.type == "cpu":
        csm_cuda.check_sweep_args(win, hr, hc, ok, origins, **kw)
        return sweep_tiles_plain(win, hr, hc, ok, origins, **kw)
    if win.dtype == torch.float32:
        return csm_cuda.csm_sweep_f32(win, hr, hc, ok, origins, **kw)
    return csm_cuda.csm_sweep(win, hr, hc, ok, origins, **kw)


def sweep_windows(prob, observed, row, col, ok, y0, x0, *, ny, nx, stride=1,
                  map_index=None, sweep_fn=None):
    """The sweep by per-beam windows, with no crop
    (``ops/csm.py:sweep_windows``, the JAX package's semantics oracle):
    ``S[t, j, i] = sum_b map[row[t,b] + y0 + j * stride, col[t,b] + x0 + i
    * stride]`` over the valid beams ``ok``, cells off the map reading 0
    (unknown).  One :func:`sweep` with the whole map as the window, the
    beams' map cells and one tile at ``(y0, x0)``: the JAX package clips
    each window start into a zero pad, which reads zeros exactly where the
    sweep reads off its window.  u8 maps sweep u8 levels (exact), f32 maps
    their f32 values unrounded (the JAX form contracts them in f32 at any
    precision).

    Cells ``[T, B]`` against one map ``[H, W]`` give ``(scores, known)``
    f32 ``[T, ny, nx]``; cells ``[N, T, B]`` give ``[N, T, ny, nx]``,
    against one map or a stack ``[M, H, W]`` with ``map_index`` (i64
    ``[N]``).  ``sweep_fn`` is called in place of :func:`sweep` if given."""
    single = row.ndim == 2
    if single:
        row, col, ok = row[None], col[None], ok[None]
    N, T = row.shape[:2]
    if map_index is None:
        win = map_planes(prob, observed, (slice(None), slice(None)))[None]
        win = win.expand(N, *win.shape[1:])
    else:
        win = map_planes(prob, observed, (map_index,))
    # Filled on the device: no host-to-device copy, which a CUDA graph
    # could not capture
    origins = torch.empty((N, 1, 2), dtype=torch.int32, device=row.device)
    origins[..., 0] = y0
    origins[..., 1] = x0
    out = (sweep_fn or sweep)(
        win.contiguous(), row.contiguous(), col.contiguous(), ok.contiguous(),
        origins, tile_h=ny, tile_w=nx, stride=stride)
    out = out.reshape(N, T, 2, ny, nx)
    scores, known = out[:, :, 0], out[:, :, 1]
    return (scores[0], known[0]) if single else (scores, known)


def csm_sweep(prob, observed, ranges, angles, beam_mask, sensor_pose,
              theta0_index, step_theta, theta_mask, x0, y0, resolution,
              offset_xy, *, n_theta, nx, ny, stride=1, crop_rows=256,
              crop_cols=256, precision="highest"):
    """The JAX package's one-call sweep (``ops/csm.py:csm_sweep``): beam
    cells in the crop, the window at ``precision`` and one :func:`sweep`
    launch of one ``ny`` x ``nx`` tile at ``stride``; theta ``t`` is
    ``sensor_pose[2] + (theta0_index + t) * step_theta``, offset ``(j,
    i)`` the translation ``(x0 + i * stride, y0 + j * stride)`` cells.
    Returns ``(scores, known)`` f32 ``[n_theta, ny, nx]``."""
    check_precision(precision)
    hr, hc, valid, r0, c0 = beam_cells(
        ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
        theta_mask, resolution, offset_xy, n_theta=n_theta,
        crop_rows=crop_rows, crop_cols=crop_cols,
    )
    win = sweep_input_window(
        prob, observed, r0, c0, x0, y0, precision=precision,
        in_rows=crop_rows + (ny - 1) * stride,
        in_cols=crop_cols + (nx - 1) * stride,
    )
    out = sweep(
        win[None].contiguous(), hr[None], hc[None],
        (valid & theta_mask[:, None])[None],
        torch.zeros((1, 1, 2), dtype=torch.int32, device=win.device),
        tile_h=ny, tile_w=nx, stride=stride,
    )[0]  # [T, 2, ny * nx]
    return (out[:, 0].reshape(n_theta, ny, nx),
            out[:, 1].reshape(n_theta, ny, nx))


def hit_images_plain(rows, cols, *, crop_rows, crop_cols):
    """Plain PyTorch form of the hit-image build: f32 ``[T, crop_rows,
    crop_cols]`` with ``out[t, r, c]`` the number of beams b with
    ``(rows[t, b], cols[t, b]) == (r, c)``.  Pairs outside the crop
    (row -1 included) add nothing."""
    T, B = rows.shape
    ok = (rows >= 0) & (rows < crop_rows) & (cols >= 0) & (cols < crop_cols)
    t = torch.arange(T, dtype=torch.int64, device=rows.device)[:, None]
    key = (t * crop_rows + rows.long()) * crop_cols + cols.long()
    out = torch.zeros(T * crop_rows * crop_cols, dtype=torch.float32,
                      device=rows.device)
    out.index_put_((torch.where(ok, key, 0).reshape(-1),),
                   ok.reshape(-1).to(torch.float32), accumulate=True)
    return out.reshape(T, crop_rows, crop_cols)


def hit_images(rows, cols, *, crop_rows, crop_cols):
    """Hit images from crop cells with validity folded in (row -1 drops a
    beam): CPU tensors take :func:`hit_images_plain`; anything else goes
    to the kernel's wrapper, which launches on CUDA tensors and raises on
    anything it does not take."""
    if rows.device.type == "cpu":
        hit_images_cuda.check_hit_args(rows, cols, crop_rows, crop_cols)
        return hit_images_plain(rows, cols, crop_rows=crop_rows,
                                crop_cols=crop_cols)
    return hit_images_cuda.hit_images(rows, cols, crop_rows=crop_rows,
                                      crop_cols=crop_cols)


def build_hit_images(hr, hc, valid, theta_mask, *, crop_rows, crop_cols,
                     dtype=torch.float32):
    """Per-theta hit-count images ``[T, crop_rows, crop_cols]``
    (``ops/csm.py:build_hit_images``).  Beam validity and the theta mask
    fold into the rows as -1, the Pallas kernel's convention.  f32 counts
    are exact at any multiplicity (the JAX package's bf16 images agree
    while no cell holds more than 256 beams); ``dtype=torch.int8``
    narrows them through int32, so a count above 127 wraps as the JAX
    package's ``astype(int8)`` does (its callers certify the counts with
    :func:`max_hit_multiplicity`)."""
    if dtype not in (torch.float32, torch.int8):
        raise ValueError(f"hit images are f32 or int8, not {dtype}")
    ok = valid & theta_mask[:, None]
    rows = torch.where(ok, hr, -1).contiguous()
    cols = torch.where(ok, hc, -1).contiguous()
    img = hit_images(rows, cols, crop_rows=crop_rows, crop_cols=crop_cols)
    return img if dtype == torch.float32 else img.to(torch.int32).to(dtype)


# Offsets per patch matmul of the hit-image sweeps (the JAX package's
# chunk): bounds the transient patch matrix to 256 crop-sized f32 planes
# per channel; f64 patches take half as many.
_PATCH_CHUNK = 256


def _hits_x_patches(hit_img, planes, off, stride):
    """``out[ch, o, t] = sum_k hit_img[t, k] * patch(o)[ch, k]``: the
    matmul of the flat hit images with the map patches at offsets ``off``
    (i64 ``[n_off, 2]``, (j, i) in steps of ``stride``) of ``planes``
    (``[2, in_rows, in_cols]``, f32 or f64; the matmul runs in that
    type).  Returns ``[2, n_off, T]``."""
    T, CR, CC = hit_img.shape
    dt = planes.dtype
    views = planes.unfold(1, CR, stride).unfold(2, CC, stride)
    hit_t = hit_img.reshape(T, CR * CC).t().to(dt)
    chunk = _PATCH_CHUNK if dt == torch.float32 else _PATCH_CHUNK // 2
    n_off = off.shape[0]
    out = torch.empty((2, n_off, T), dtype=dt, device=planes.device)
    for o0 in range(0, n_off, chunk):
        o = off[o0:o0 + chunk]
        n = o.shape[0]
        # [2 * n, CR * CC] patches (both channels) @ [CR * CC, T]: one GEMM
        patches = views[:, o[:, 0], o[:, 1]].reshape(2 * n, CR * CC)
        out[:, o0:o0 + n] = (patches @ hit_t).view(2, n, T)
    return out


def _require_full_f32_matmuls():
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the u8 hit-image sweep needs full f32 matmuls: TF32 would "
            "round the integer sums (set "
            "torch.backends.cuda.matmul.allow_tf32 = False)"
        )


def _sweep_hits(hit_img, inp, off, stride):
    """:func:`_hits_x_patches` of a window from :func:`sweep_input_window`
    (``[in_rows, in_cols, 2]``): a u8 window in f32 (the integer sums stay
    below 2^24, exact in any order; TF32 refused), one multiply by
    f32(1/255); an f32 window rounded by :func:`round_to_fixed_point`, in
    f64 (the products of integer counts and its values are exact, and so
    are their sums, as the module docstring states), rounded to f32 once.
    f32 ``[2, n_off, T]``."""
    if inp.dtype == torch.uint8:
        _require_full_f32_matmuls()
        out = _hits_x_patches(hit_img, inp.permute(2, 0, 1).to(torch.float32),
                              off, stride)
        return out * float(quant.INV255)
    out = _hits_x_patches(
        hit_img, round_to_fixed_point(inp).permute(2, 0, 1).to(torch.float64),
        off, stride)
    return out.to(torch.float32)


def sweep_from_hits(hit_img, r0, c0, prob, observed, x0, y0, *, nx, ny,
                    stride, precision):
    """Window sweep of precomputed hit images against a map
    (``ops/csm.py:sweep_from_hits``): ``(scores, known)`` f32 ``[T, ny,
    nx]`` for offsets ``(x0 + i * stride, y0 + j * stride)``.  The map
    patches at every offset are multiplied with the flat hit images
    (:func:`_sweep_hits`): on a u8 map at any precision but
    ``"highest"`` this gives the JAX package's values bit for bit; on an
    f32 window, the exact sums of the window rounded at ``precision``."""
    T, CR, CC = hit_img.shape
    inp = sweep_input_window(prob, observed, r0, c0, x0, y0,
                             in_rows=CR + (ny - 1) * stride,
                             in_cols=CC + (nx - 1) * stride,
                             precision=precision)
    out = _sweep_hits(hit_img, inp, grid_offsets(ny, nx, 1, inp.device).long(),
                      stride)
    return (out[0].t().reshape(T, ny, nx), out[1].t().reshape(T, ny, nx))


def sweep_from_hits_at(hit_img, r0, c0, prob, observed, x0, y0, off_ji, *,
                       max_j, max_i, precision):
    """:func:`sweep_from_hits` at an explicit offset list
    (``ops/csm.py:sweep_from_hits_at``): ``off_ji`` i32 ``[n_off, 2]``,
    the (j, i) cells from the window origin ``(y0, x0)``, clipped to
    ``[0, max_j]`` x ``[0, max_i]``.  Returns ``(scores, known)`` f32
    ``[T, n_off]``."""
    T, CR, CC = hit_img.shape
    inp = sweep_input_window(prob, observed, r0, c0, x0, y0,
                             in_rows=CR + max_j, in_cols=CC + max_i,
                             precision=precision)
    off = torch.stack([torch.clamp(off_ji[:, 0], 0, max_j),
                       torch.clamp(off_ji[:, 1], 0, max_i)], -1).long()
    out = _sweep_hits(hit_img, inp, off.to(inp.device), 1)
    return out[0].t(), out[1].t()


class HitImages(NamedTuple):
    """A batch's hit images (:func:`build_hit_images_batch`): ``img`` f32
    ``[N, T, crop_rows, crop_cols]``, the crop rows they were built from
    with beam validity and the theta mask folded in as -1 (``rows`` i32
    ``[N, T, B]``), and the crop anchors ``r0``, ``c0`` (i32 ``[N]``)."""

    img: torch.Tensor
    rows: torch.Tensor
    r0: torch.Tensor
    c0: torch.Tensor


def build_hit_images_batch(hr, hc, valid, theta_mask, r0, c0, *, crop_rows,
                           crop_cols) -> HitImages:
    """:func:`build_hit_images` of N candidates at once, from their beam
    cells ``[N, T, B]``, theta masks ``[N, T]`` and crop anchors ``[N]``
    (:func:`beam_cells` with a candidate axis).  Each theta row is
    independent, so the N * T rows are one call of :func:`hit_images`: one
    kernel launch on the card, whatever N is."""
    N, T, B = hr.shape
    ok = valid & theta_mask[..., None]
    rows = torch.where(ok, hr, -1).contiguous()
    cols = torch.where(ok, hc, -1).contiguous()
    img = hit_images(rows.view(N * T, B), cols.view(N * T, B),
                     crop_rows=crop_rows, crop_cols=crop_cols)
    return HitImages(img.view(N, T, crop_rows, crop_cols), rows, r0, c0)


def _runs(cand):
    """``(value, start, end)`` of each run of equal values in ``cand``."""
    out, start = [], 0
    for i in range(1, len(cand) + 1):
        if i == len(cand) or cand[i] != cand[start]:
            out.append((cand[start], start, i))
            start = i
    return out


def sweep_from_hits_batch(hits: HitImages, prob, observed, x0, y0, *, nx,
                          ny, stride, precision, cand, map_index=None):
    """:func:`sweep_from_hits` of P windows of a batch's hit images in one
    call: window ``w`` sweeps candidate ``cand[w]``'s images against its
    map at offsets ``(x0[w] + i * stride, y0[w] + j * stride)``.  ``cand``
    is a host list of P candidate indices, its equal values adjacent;
    ``x0``, ``y0`` are i32 ``[P]`` on the device.  The maps are one raster
    ``[H, W]``, or a stack ``[M, H, W]`` with ``map_index`` (i64 ``[N]``)
    naming each candidate's.

    The P windows are cut in one gather; each candidate's windows are
    then one matmul of their patches with its flat images (at most
    :data:`_PATCH_CHUNK` offsets a product, as :func:`_hits_x_patches`),
    so every sum is the serial form's, bit for bit.  Returns ``(scores,
    known)`` f32 ``[P, T, ny, nx]``."""
    _, T, CR, CC = hits.img.shape
    dev = hits.img.device
    groups = _runs(cand)
    idx = torch.cat([torch.full((e - s,), c, dtype=torch.int64, device=dev)
                     for c, s, e in groups])
    inp = sweep_input_window(
        prob, observed, hits.r0[idx], hits.c0[idx], x0, y0,
        in_rows=CR + (ny - 1) * stride, in_cols=CC + (nx - 1) * stride,
        precision=precision,
        map_index=None if map_index is None else map_index[idx])
    if inp.dtype == torch.uint8:
        _require_full_f32_matmuls()
        planes = inp.permute(0, 3, 1, 2).to(torch.float32)
        chunk = _PATCH_CHUNK
    else:
        planes = round_to_fixed_point(inp).permute(0, 3, 1, 2).to(
            torch.float64)
        chunk = _PATCH_CHUNK // 2
    # [P, 2, ny, nx, CR, CC]: window w's patch at offset (j, i), per channel
    views = planes.unfold(2, CR, stride).unfold(3, CC, stride)
    per = max(1, chunk // (ny * nx))
    out = torch.empty((len(cand), 2, ny, nx, T), dtype=planes.dtype,
                      device=dev)
    for c, s, e in groups:
        hit_t = hits.img[c].reshape(T, CR * CC).t().to(planes.dtype)
        for w0 in range(s, e, per):
            w1 = min(e, w0 + per)
            patches = views[w0:w1].reshape(-1, CR * CC)
            out[w0:w1] = (patches @ hit_t).view(w1 - w0, 2, ny, nx, T)
    if inp.dtype == torch.uint8:
        out = out * float(quant.INV255)
    else:
        out = out.to(torch.float32)
    return (out[:, 0].permute(0, 3, 1, 2), out[:, 1].permute(0, 3, 1, 2))


def sweep_from_hits_int8(hit_i8, row_counts, inp_u8, *, nx, ny, stride):
    """The JAX package's int8 sweep (``ops/csm.py:sweep_from_hits_int8``)
    with its integer arithmetic: the window's levels centered to ``v -
    128``, contracted with the int8 hit counts (wrapped counts included,
    as there), ``128 * row_counts[t]`` restored and the sum scaled by
    f32(1/255) in the JAX package's order.  ``inp_u8`` is the port's u8
    window ``[in_rows, in_cols, 2]`` (:func:`sweep_input_window`),
    ``row_counts`` f32 ``[T]``.  The contraction runs in f64, where its
    integer products and sums (below 2^40) are exact on either device.
    Returns ``(scores, known)`` f32 ``[T, ny, nx]``."""
    T = hit_i8.shape[0]
    centered = inp_u8.permute(2, 0, 1).to(torch.float64) - 128.0
    S = _hits_x_patches(hit_i8, centered,
                        grid_offsets(ny, nx, 1, inp_u8.device).long(), stride)
    out = ((S.to(torch.float32) + 128.0 * row_counts[None, None, :])
           * float(quant.INV255))
    return (out[0].t().reshape(T, ny, nx), out[1].t().reshape(T, ny, nx))
