"""Correlative scan matching (CSM) sweep.

Port of ``my_lidar_graph_slam_v2_tpu/ops/csm.py``.  The JAX package
scores the pose window with one-hot hit images and matmuls on the MXU
(``build_hit_images`` + ``sweep_from_hits`` / ``sweep_from_hits_int8`` /
``sweep_from_hits_at``).  Here the same integer sums are taken straight
from the per-(theta, beam) endpoint cells::

    S[n, t, ch, o] = sum_b ok[n,t,b] * win[n, hr[n,t,b] + oj[o], hc[n,t,b] + oi[o], ch]
    out = float32(S) * float32(1/255)

with ``win`` the u8 window cut by :func:`sweep_input_window`, its two
channels (prob level, observed * 255) interleaved in one 2-byte cell.  On
u8 maps the XLA forms compute exactly these integers (their accumulation
is exact below 2^24), so the scores are bit-identical.  The offsets are
rectangular tiles: the strided coarse grid and the dense fine grid are one
tile each, the block-pruned fine sweep is one 5x5 tile per selected block
(:func:`tile_offsets` spells them out).

:func:`sweep` is the entry point: CPU tensors take :func:`sweep_tiles_plain`,
CUDA tensors launch the hand-written kernel (``ops/csm_cuda.py``).

Branch-and-bound keeps the JAX package's two-step form: it builds the hit
images once per match (:func:`build_hit_images`; on CUDA tensors the
hand-written kernel of ``ops/hit_images_cuda.py``) and shares them
between its bound sweep and every block sweep (:func:`sweep_from_hits`, a
plain f32 matmul against the map patches, exact on u8 maps).
"""
from __future__ import annotations

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


def sweep_input_window(prob, observed, r0, c0, x0, y0, *, in_rows, in_cols,
                       map_index=None):
    """The u8 ``[..., in_rows, in_cols, 2]`` window the sweep correlates
    against, channels interleaved (prob level, observed * 255):
    ``win[r, c, :] = map[r0+y0+r, c0+x0+c]`` with zeros outside the
    raster, one window per anchor ``r0``, ``c0`` (``[...]``).

    The maps are one raster ``[H, W]`` shared by every anchor, or a stack
    of a step's distinct rasters ``[M, H, W]`` with ``map_index`` (i64
    ``[N]``) naming each candidate's raster.  The window start follows
    ``jax.lax.dynamic_slice`` into the map padded by ``max(in_rows,
    in_cols)`` on every side: a start that would run off the padded plane
    is clamped so the window fits.  The cut is a gather with device-side
    indices, so no anchor value goes to the host."""
    if prob.dtype != torch.uint8:
        raise NotImplementedError(
            "the sweep takes u8 probability maps only; f32 maps are "
            "ROADMAP item 1.4 (precision='highest')"
        )
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
    p = torch.where(inside, prob[idx], 0)
    o = torch.where(inside & observed[idx], 255, 0).to(torch.uint8)
    return torch.stack([p, o], dim=-1)


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
# index tensors to a few hundred MB at the loop-detector shape).
_PLAIN_CHUNK = 1 << 25


def sweep_plain(win, hr, hc, ok, off, scale=quant.INV255):
    """Plain PyTorch form of the sweep at explicit offsets: gather ``win``
    at ``[hr + oj, hc + oi]`` (masked beams and cells off the window read
    a zero cell), sum over beams in int32, then one f32 multiply by
    ``scale``.

    Shapes: win u8 ``[N, in_r, in_c, 2]``; hr, hc i32 and ok bool
    ``[N, T, B]``; off i32 ``[N, n_off, 2]``, per candidate.  Returns f32
    ``[N, T, 2, n_off]``."""
    N, in_r, in_c, _ = win.shape
    T, B = hr.shape[1], hr.shape[2]
    L = in_r * in_c
    flat = torch.cat(
        [win.reshape(N, L, 2).transpose(1, 2).to(torch.int32),
         torch.zeros((N, 2, 1), dtype=torch.int32, device=win.device)],
        dim=-1,
    )
    step = max(1, _PLAIN_CHUNK // (N * T * B * 2))
    parts = []
    for o0 in range(0, off.shape[1], step):
        oj = off[:, o0:o0 + step, 0, None, None].transpose(1, 2)  # [., 1, o, 1]
        oi = off[:, o0:o0 + step, 1, None, None].transpose(1, 2)
        r = hr[:, :, None, :] + oj  # [N, T, o, B]
        c = hc[:, :, None, :] + oi
        inb = ok[:, :, None, :] & (r >= 0) & (r < in_r) & (c >= 0) & (c < in_c)
        idx = torch.where(inb, r * in_c + c, L).long()
        g = torch.gather(flat, 2, idx.reshape(N, 1, -1).expand(N, 2, -1))
        parts.append(g.reshape(N, 2, T, -1, B).sum(-1, dtype=torch.int32))
    S = torch.cat(parts, dim=-1).permute(0, 2, 1, 3)
    return S.to(torch.float32) * float(scale)


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
    tile_w]`` (scores, known): win u8 ``[N, in_r, in_c, 2]``, beams ``[N,
    T, B]``, tile origins i32 ``[N, K, 2]`` (see ``ops/csm_cuda.py``).
    CPU tensors take :func:`sweep_tiles_plain`; anything else goes to the
    kernel's wrapper, which launches on CUDA tensors and raises on
    anything it does not take."""
    kw = dict(tile_h=tile_h, tile_w=tile_w, stride=stride)
    if win.device.type == "cpu":
        csm_cuda.check_sweep_args(win, hr, hc, ok, origins, **kw)
        return sweep_tiles_plain(win, hr, hc, ok, origins, **kw)
    return csm_cuda.csm_sweep(win, hr, hc, ok, origins, **kw)


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


def build_hit_images(hr, hc, valid, theta_mask, *, crop_rows, crop_cols):
    """Per-theta hit-count images, f32 ``[T, crop_rows, crop_cols]``
    (``ops/csm.py:build_hit_images``).  Beam validity and the theta mask
    fold into the rows as -1, the Pallas kernel's convention.  The counts
    are exact at any multiplicity; the JAX package's bf16 images agree
    while no cell holds more than 256 beams."""
    ok = valid & theta_mask[:, None]
    rows = torch.where(ok, hr, -1).contiguous()
    cols = torch.where(ok, hc, -1).contiguous()
    return hit_images(rows, cols, crop_rows=crop_rows, crop_cols=crop_cols)


# Offsets per patch matmul of sweep_from_hits (the JAX package's chunk):
# bounds the transient patch matrix to 256 crop-sized planes per channel.
_PATCH_CHUNK = 256


def sweep_from_hits(hit_img, r0, c0, prob, observed, x0, y0, *, nx, ny,
                    stride, precision):
    """Window sweep of precomputed hit images against a u8 map
    (``ops/csm.py:sweep_from_hits``, its u8-exact branch): ``(scores,
    known)`` f32 ``[T, ny, nx]`` for offsets ``(x0 + i * stride, y0 + j *
    stride)``.

    The map patches at every offset are multiplied with the flat hit
    images in f32 (TF32 off, see ``pipeline/factory.py``): the terms are
    integers and the sums stay below 2^24, so they are exact in any
    order, and one multiply by f32(1/255) gives the JAX package's values
    bit for bit.  f32 maps and ``precision="highest"`` raise."""
    if precision == "highest":
        raise NotImplementedError(
            "precision='highest' (f32 maps) is not ported (ROADMAP item "
            "1.4); the sweep takes u8 maps"
        )
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "sweep_from_hits needs full f32 matmuls: TF32 would round the "
            "integer sums (set torch.backends.cuda.matmul.allow_tf32 = False)"
        )
    T, CR, CC = hit_img.shape
    in_rows = CR + (ny - 1) * stride
    in_cols = CC + (nx - 1) * stride
    inp = sweep_input_window(prob, observed, r0, c0, x0, y0,
                             in_rows=in_rows, in_cols=in_cols)
    views = inp.permute(2, 0, 1).to(torch.float32)
    views = views.unfold(1, CR, stride).unfold(2, CC, stride)
    hit_t = hit_img.reshape(T, CR * CC).t()
    off = grid_offsets(ny, nx, 1, inp.device).long()
    n_off = ny * nx
    out = torch.empty((2, n_off, T), dtype=torch.float32, device=inp.device)
    for o0 in range(0, n_off, _PATCH_CHUNK):
        o = off[o0:o0 + _PATCH_CHUNK]
        n = o.shape[0]
        # [2 * n, CR * CC] patches (both channels) @ [CR * CC, T]: one GEMM
        patches = views[:, o[:, 0], o[:, 1]].reshape(2 * n, CR * CC)
        out[:, o0:o0 + n] = (patches @ hit_t).view(2, n, T)
    out = out * float(quant.INV255)
    return (out[0].t().reshape(T, ny, nx), out[1].t().reshape(T, ny, nx))
