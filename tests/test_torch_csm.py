"""Parity of the port's CSM sweep (ops/csm.py) with the JAX package's.

Inputs come from a seeded NumPy generator and go to both packages as
NumPy arrays.  On u8 maps the JAX XLA sweeps compute exact integer sums
times float32(1/255), so the port's plain sweep must equal them bit for
bit (assert_array_equal, no tolerance).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda


def _cells(rng, T, B, crop, frac_valid=0.9):
    hr = rng.integers(0, crop, (T, B)).astype(np.int32)
    hc = rng.integers(0, crop, (T, B)).astype(np.int32)
    valid = rng.uniform(size=(T, B)) < frac_valid
    theta_mask = np.ones(T, bool)
    theta_mask[: T // 8] = False
    return hr, hc, valid, theta_mask


def _u8_map(rng, H, W):
    obs = rng.uniform(size=(H, W)) < 0.7
    prob = np.where(obs, rng.integers(1, 256, (H, W)), 0).astype(np.uint8)
    return prob, obs


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_sweep(win, hr, hc, ok, off, scale=csm.quant.INV255):
    """The port's plain sweep of one candidate; ``win`` is ``[in_r, in_c,
    2]`` (channels interleaved)."""
    out = csm.sweep_plain(
        _t(win)[None], _t(hr)[None], _t(hc)[None], _t(ok)[None],
        _t(off)[None], scale=scale,
    )[0].numpy()
    return out[:, 0], out[:, 1]  # [T, n_off]


def _hits(hr, hc, valid, theta_mask, crop, dtype):
    return jcsm.build_hit_images(
        jnp.asarray(hr), jnp.asarray(hc), jnp.asarray(valid),
        jnp.asarray(theta_mask), crop_rows=crop, crop_cols=crop, dtype=dtype,
    )


@pytest.mark.parametrize("ny,nx,stride", [(2, 2, 5), (10, 10, 1)])
def test_plain_sweep_equals_int8_sweep(ny, nx, stride):
    rng = np.random.default_rng(10 + ny)
    T, B, crop = 24, 96, 48
    hr, hc, valid, theta_mask = _cells(rng, T, B, crop)
    ok = valid & theta_mask[:, None]
    in_r, in_c = crop + (ny - 1) * stride, crop + (nx - 1) * stride
    win = np.stack([rng.integers(0, 256, (in_r, in_c)),
                    255 * (rng.uniform(size=(in_r, in_c)) < 0.6)]).astype(np.uint8)
    hit = _hits(hr, hc, valid, theta_mask, crop, jnp.int8)
    s_j, k_j = jcsm.sweep_from_hits_int8(
        hit, jnp.asarray(ok.sum(1).astype(np.float32)), jnp.asarray(win),
        nx=nx, ny=ny, stride=stride,
    )
    s_p, k_p = _port_sweep(win.transpose(1, 2, 0), hr, hc, ok,
                           csm.grid_offsets(ny, nx, stride, "cpu"))
    np.testing.assert_array_equal(s_p.reshape(T, ny, nx), np.asarray(s_j))
    np.testing.assert_array_equal(k_p.reshape(T, ny, nx), np.asarray(k_j))


# (ny, nx): a frontend fine window, and one above 256 offsets (the JAX
# package's XLA:CPU conv branch).  r0/c0: inside the map, and hanging off
# its low corner (zeros outside the raster).
@pytest.mark.parametrize("ny,nx,r0,c0", [(10, 10, 40, 55), (17, 17, -20, 90)])
def test_plain_sweep_equals_bf16_sweep(ny, nx, r0, c0):
    rng = np.random.default_rng(20 + nx)
    T, B, crop, H, W = 16, 80, 40, 160, 150
    hr, hc, valid, theta_mask = _cells(rng, T, B, crop)
    prob, obs = _u8_map(rng, H, W)
    x0, y0 = -3, -4
    hit = _hits(hr, hc, valid, theta_mask, crop, jnp.bfloat16)
    s_j, k_j = jcsm.sweep_from_hits(
        hit, jnp.int32(r0), jnp.int32(c0), jnp.asarray(prob), jnp.asarray(obs),
        jnp.int32(x0), jnp.int32(y0), nx=nx, ny=ny, stride=1, precision="split",
    )
    win = csm.sweep_input_window(
        _t(prob), _t(obs), torch.tensor(r0, dtype=torch.int32),
        torch.tensor(c0, dtype=torch.int32), x0, y0,
        in_rows=crop + ny - 1, in_cols=crop + nx - 1,
    ).numpy()
    s_p, k_p = _port_sweep(win, hr, hc, valid & theta_mask[:, None],
                           csm.grid_offsets(ny, nx, 1, "cpu"))
    np.testing.assert_array_equal(s_p.reshape(T, ny, nx), np.asarray(s_j))
    np.testing.assert_array_equal(k_p.reshape(T, ny, nx), np.asarray(k_j))


def test_plain_sweep_equals_explicit_offset_sweep():
    rng = np.random.default_rng(30)
    T, B, crop, H, W = 12, 64, 48, 140, 140
    hr, hc, valid, theta_mask = _cells(rng, T, B, crop)
    prob, obs = _u8_map(rng, H, W)
    r0, c0, x0, y0 = 30, 25, -25, -25
    max_j = max_i = 54  # 11 x 11 blocks of 5, as the loop window
    by, bx = rng.integers(0, 11, 6), rng.integers(0, 11, 6)
    d = np.arange(5)
    off = np.stack([
        (by[:, None] * 5 + np.repeat(d, 5)[None]).reshape(-1),
        (bx[:, None] * 5 + np.tile(d, 5)[None]).reshape(-1),
    ], -1).astype(np.int32)
    hit = _hits(hr, hc, valid, theta_mask, crop, jnp.bfloat16)
    s_j, k_j = jcsm.sweep_from_hits_at(
        hit, jnp.int32(r0), jnp.int32(c0), jnp.asarray(prob), jnp.asarray(obs),
        jnp.int32(x0), jnp.int32(y0), jnp.asarray(off),
        max_j=max_j, max_i=max_i, precision="split",
    )
    win = csm.sweep_input_window(
        _t(prob), _t(obs), torch.tensor(r0, dtype=torch.int32),
        torch.tensor(c0, dtype=torch.int32), x0, y0,
        in_rows=crop + max_j, in_cols=crop + max_i,
    ).numpy()
    s_p, k_p = _port_sweep(win, hr, hc, valid & theta_mask[:, None], off)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    np.testing.assert_array_equal(k_p, np.asarray(k_j))


def test_plain_sweep_against_pallas_interpret():
    """The Pallas kernel (interpret mode) rounds the map to bf16 before its
    matmul, hence its own test's atol=0.05 on scores.  Known counts are
    exact integers on both sides: the Pallas kernel returns the count,
    the port (with scale 1) 255 * count."""
    from my_lidar_graph_slam_v2_tpu.ops import csm_pallas

    rng = np.random.default_rng(40)
    T, B, crop, ny, nx = 8, 48, 64, 4, 4
    hr, hc, valid, theta_mask = _cells(rng, T, B, crop)
    ok = valid & theta_mask[:, None]
    in_r, in_c = crop + ny - 1, crop + nx - 1
    win = np.stack([rng.integers(0, 256, (in_r, in_c)),
                    255 * (rng.uniform(size=(in_r, in_c)) < 0.6)]).astype(np.uint8)
    inp = np.stack([win[0].astype(np.float32) * np.float32(1 / 255),
                    (win[1] > 0).astype(np.float32)])
    s_j, k_j = csm_pallas.sweep(
        jnp.asarray(inp), jnp.asarray(np.where(ok, hr, -1)), jnp.asarray(hc),
        nx=nx, ny=ny, stride=1, crop_rows=crop, crop_cols=crop,
        interpret=True,
    )
    s_p, k_p = _port_sweep(win.transpose(1, 2, 0), hr, hc, ok,
                           csm.grid_offsets(ny, nx, 1, "cpu"), scale=1.0)
    np.testing.assert_allclose((s_p / 255).reshape(T, ny, nx), np.asarray(s_j),
                               atol=0.05)
    np.testing.assert_array_equal(k_p.reshape(T, ny, nx),
                                  255 * np.asarray(k_j))


def _scan(rng, B=128):
    ranges = rng.uniform(0.5, 6.0, B).astype(np.float32)
    angles = np.linspace(-2.2, 2.2, B).astype(np.float32)
    mask = rng.uniform(size=B) < 0.9
    return ranges, angles, mask


def test_theta_search_params():
    """The theta step is ``2 asin(0.5 res / max_range)`` in f32: torch's
    and XLA:CPU's asin may differ in the last ulp (measured: 1 ulp), so
    the step is held to 2 ulp (rtol 2.4e-7); window index and mask are
    integers and must be equal."""
    rng = np.random.default_rng(50)
    ranges, _, mask = _scan(rng)
    for T in (16, 96, 208):
        j = jcsm.theta_search_params(jnp.asarray(ranges), jnp.asarray(mask),
                                     0.05, 0.5, T)
        p = csm.theta_search_params(_t(ranges), _t(mask), 0.05, 0.5, T)
        np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]),
                                   rtol=2.4e-7, atol=0)
        np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))


def test_beam_cells_flip_count_bounded():
    """``floor(f32 trig / res)``: torch and XLA:CPU may differ in the last
    ulp of cos/sin, moving an endpoint one cell.  Bound: at most 0.5% of
    (theta, beam) cells move, by one cell, and the anchor agrees."""
    rng = np.random.default_rng(60)
    ranges, angles, mask = _scan(rng)
    T = 96
    sp = np.float32([0.31, -0.17, 0.23])
    off = np.float32([-12.8, -12.8])
    j = jcsm.theta_search_params(jnp.asarray(ranges), jnp.asarray(mask), 0.05, 0.5, T)
    hr_j, hc_j, v_j, r0_j, c0_j = jcsm.beam_cells(
        jnp.asarray(ranges), jnp.asarray(angles), jnp.asarray(mask),
        jnp.asarray(sp), j[1], j[0], j[2], 0.05, jnp.asarray(off),
        n_theta=T, crop_rows=320, crop_cols=320,
    )
    p = csm.theta_search_params(_t(ranges), _t(mask), 0.05, 0.5, T)
    hr_p, hc_p, v_p, r0_p, c0_p = csm.beam_cells(
        _t(ranges), _t(angles), _t(mask), _t(sp), p[1], p[0], p[2], 0.05,
        _t(off), n_theta=T, crop_rows=320, crop_cols=320,
    )
    assert int(r0_p) == int(r0_j) and int(c0_p) == int(c0_j)
    dr = np.abs(hr_p.numpy() - np.asarray(hr_j))
    dc = np.abs(hc_p.numpy() - np.asarray(hc_j))
    assert dr.max() <= 1 and dc.max() <= 1
    flips = int(((dr + dc) > 0).sum())
    assert flips <= 0.005 * dr.size, flips
    assert int((v_p.numpy() != np.asarray(v_j)).sum()) <= flips


@pytest.mark.parametrize("degenerate", [False, True])
def test_max_hit_multiplicity(degenerate):
    rng = np.random.default_rng(70)
    T, B, crop = 10, 256, 32
    hr, hc, valid, theta_mask = _cells(rng, T, B, crop)
    if degenerate:  # > 127 beams in one cell at theta 3
        hr[3, :200], hc[3, :200], valid[3, :200] = 7, 9, True
    ok = valid & theta_mask[:, None]
    j = jcsm.max_hit_multiplicity(jnp.asarray(hr), jnp.asarray(hc),
                                  jnp.asarray(ok), crop_cols=crop)
    p = csm.max_hit_multiplicity(_t(hr), _t(hc), _t(ok), crop_cols=crop)
    assert int(p) == int(j)
    assert (int(p) > 127) == degenerate


def test_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(80)
    T, B, crop = 6, 40, 24
    hr, hc, valid, _ = _cells(rng, T, B, crop)
    win = torch.as_tensor(rng.integers(0, 256, (1, crop + 4, crop + 4, 2)).astype(np.uint8))
    origins = torch.zeros((1, 1, 2), dtype=torch.int32)
    args = (win, _t(hr)[None], _t(hc)[None], _t(valid)[None], origins)
    kw = dict(tile_h=5, tile_w=5, stride=1)
    before = csm_cuda.LAUNCHES
    out = csm.sweep(*args, **kw)
    assert csm_cuda.LAUNCHES == before
    assert torch.equal(out, csm.sweep_plain(*args[:4], csm.grid_offsets(5, 5, 1, "cpu")[None]))
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(*args, **kw)  # launches on CUDA tensors only
    with pytest.raises(ValueError):
        csm.sweep(win.to(torch.int32), *args[1:], **kw)


def _bad_args(case):
    """Sweep arguments broken in one way each; the rest are valid.  ``off``
    in a case's name stands for the tile origins."""
    rng = np.random.default_rng(81)
    hr, hc, valid, _ = _cells(rng, 4, 16, 12)
    args = dict(
        win=torch.as_tensor(rng.integers(0, 256, (2, 16, 16, 2)).astype(np.uint8)),
        hr=_t(np.stack([hr, hr])), hc=_t(np.stack([hc, hc])),
        ok=_t(np.stack([valid, valid])),
        origins=torch.zeros((2, 1, 2), dtype=torch.int32),
        tile_h=3, tile_w=3, stride=1,
    )
    if case == "win one channel":
        args["win"] = args["win"][..., :1].contiguous()
    elif case == "win channels first":
        args["win"] = args["win"].permute(0, 3, 1, 2).contiguous()
    elif case == "win f64":
        args["win"] = args["win"].double()
    elif case == "hr int64":
        args["hr"] = args["hr"].long()
    elif case == "ok uint8":
        args["ok"] = args["ok"].to(torch.uint8)
    elif case == "hr batch differs":
        args["hr"] = args["hr"][:1].contiguous()
    elif case == "hc shape differs":
        args["hc"] = args["hc"][:, :, :8].contiguous()
    elif case == "off int64":
        args["origins"] = args["origins"].long()
    elif case == "off not pairs":
        args["origins"] = args["origins"][..., :1].contiguous()
    elif case == "origins batch differs":
        args["origins"] = args["origins"][:1].contiguous()
    elif case == "no tiles":
        args["origins"] = args["origins"][:, :0].contiguous()
    elif case == "tile height 0":
        args["tile_h"] = 0
    elif case == "stride 0":
        args["stride"] = 0
    elif case == "tile width float":
        args["tile_w"] = 3.0
    return args


BAD_CASES = ["win one channel", "win f64", "hr int64", "ok uint8",
             "hr batch differs", "hc shape differs", "off int64",
             "off not pairs", "win channels first", "origins batch differs",
             "no tiles", "tile height 0", "stride 0", "tile width float"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_sweep_and_kernel_wrapper_reject_what_the_kernel_does_not_take(case):
    """Both the dispatcher and the kernel's own wrapper validate dtype and
    shape: the wrapper's message names the argument, not the device, so
    its checks ran before the device check."""
    args = _bad_args(case)
    with pytest.raises(ValueError, match="must be|differ"):
        csm.sweep(**args)
    with pytest.raises(ValueError, match="must be|differ"):
        csm_cuda.csm_sweep(**args)


# The tile form of the sweep, on the cases the card's kernel is held to
# (tests/torch_card_cases.py: tiles off the window, beams on its edge, an
# all-masked theta, 300 beams in one cell, rows not 4-byte aligned).
from torch_card_cases import (  # noqa: E402
    KERNEL_SHAPES,
    TILE_CASES,
    kernel_shape,
    kernel_shapes,
    tile_case,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _brute_sweep(win, hr, hc, ok, off):
    """NumPy loop form of the sweep at per-candidate offsets ``off [N,
    n_off, 2]``: independent of the port's gather."""
    N, in_r, in_c, _ = win.shape
    S = np.zeros((N, hr.shape[1], 2, off.shape[1]), np.int64)
    for n in range(N):
        for o, (oj, oi) in enumerate(off[n]):
            r, c = hr[n] + oj, hc[n] + oi
            inb = ok[n] & (r >= 0) & (r < in_r) & (c >= 0) & (c < in_c)
            vals = win[n, np.clip(r, 0, in_r - 1), np.clip(c, 0, in_c - 1)]
            S[n, :, :, o] = (vals * inb[..., None]).sum(1)
    return S.astype(np.float32) * np.float32(1 / 255)


@pytest.mark.parametrize("name", TILE_CASES)
def test_tile_sweep_equals_explicit_offsets_and_brute_force(name):
    win, hr, hc, ok, origins, (th, tw, stride), _ = tile_case(name)
    args = [torch.as_tensor(a) for a in (win, hr, hc, ok)]
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    got = csm.sweep(*args, torch.as_tensor(origins), **kw)
    off = csm.tile_offsets(torch.as_tensor(origins), **kw)
    assert off.shape == (win.shape[0], origins.shape[1] * th * tw, 2)
    assert torch.equal(got, csm.sweep_plain(*args, off))
    np.testing.assert_array_equal(got.numpy(),
                                  _brute_sweep(win, hr, hc, ok, off.numpy()))


@pytest.mark.parametrize("name", KERNEL_SHAPES)
def test_kernel_shape_cases_are_the_systems_sweeps(name):
    """The card's cases at the system's shapes (``torch_card_cases``, which
    the card tests and ``chip_smoke.py``'s kernel times take): each named
    shape's widths and tile, its beams in the crop, and arguments the
    sweep takes."""
    assert [s["shape"] for s in kernel_shapes()] == list(KERNEL_SHAPES)
    s = kernel_shape(name)
    win, hr, hc, ok, origins, tile, crop = tile_case(name)
    assert win.shape == (s["N"], s["in_r"], s["in_c"], 2)
    assert hr.shape == hc.shape == ok.shape == (s["N"], s["T"], s["B"])
    assert tile == s["tile"] and crop == s["crop"] and ok.any()
    assert (hr[ok] >= 0).all() and (hr[ok] < crop).all()
    assert (hc[ok] >= 0).all() and (hc[ok] < crop).all()
    th, tw, stride = tile
    csm_cuda.check_sweep_args(
        *[torch.as_tensor(a) for a in (win, hr, hc, ok, origins)],
        tile_h=th, tile_w=tw, stride=stride)


# Cases whose offsets all stay inside the window, where the JAX package's
# explicit-offset sweep (which clips offsets) computes the same sums.
IN_WINDOW = ["one tile", "block tiles", "strided tile", "masked theta",
             "300-beam cell", "unaligned rows"]


@pytest.mark.parametrize("name", IN_WINDOW)
def test_tile_sweep_equals_jax_sweeps(name):
    """The port's tile sweep against ``sweep_from_hits_at`` (bf16 hit
    images, the window as the map) on every case, and against
    ``sweep_from_hits_int8`` on the one-tile cases at origin 0 whose hit
    multiplicity passes the int8 certificate."""
    win, hr, hc, ok, origins, (th, tw, stride), crop = tile_case(name)
    kw = dict(tile_h=th, tile_w=tw, stride=stride)
    got = csm.sweep(*[torch.as_tensor(a) for a in (win, hr, hc, ok, origins)],
                    **kw).numpy()
    N, in_r, in_c, _ = win.shape
    theta_mask = np.ones(hr.shape[1], bool)
    off = csm.tile_offsets(torch.as_tensor(origins), **kw).numpy()
    for n in range(N):
        hit = _hits(hr[n], hc[n], ok[n], theta_mask, crop, jnp.bfloat16)
        zero = jnp.int32(0)
        s_j, k_j = jcsm.sweep_from_hits_at(
            hit, zero, zero, jnp.asarray(win[n, ..., 0]),
            jnp.asarray(win[n, ..., 1] > 0), zero, zero, jnp.asarray(off[n]),
            max_j=in_r - crop, max_i=in_c - crop, precision="split",
        )
        np.testing.assert_array_equal(got[n, :, 0], np.asarray(s_j))
        np.testing.assert_array_equal(got[n, :, 1], np.asarray(k_j))
        one_tile = origins.shape[1] == 1 and not origins.any()
        mult = csm.max_hit_multiplicity(_t(hr[n]), _t(hc[n]), _t(ok[n]),
                                        crop_cols=crop)
        if one_tile and int(mult) <= 127:
            s_8, k_8 = jcsm.sweep_from_hits_int8(
                _hits(hr[n], hc[n], ok[n], theta_mask, crop, jnp.int8),
                jnp.asarray(ok[n].sum(1).astype(np.float32)),
                jnp.asarray(win[n].transpose(2, 0, 1)), nx=tw, ny=th,
                stride=stride,
            )
            np.testing.assert_array_equal(got[n, :, 0],
                                          np.asarray(s_8).reshape(-1, th * tw))
            np.testing.assert_array_equal(got[n, :, 1],
                                          np.asarray(k_8).reshape(-1, th * tw))
        else:
            assert not one_tile or name == "300-beam cell"
