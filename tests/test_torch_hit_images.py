"""The port's hit-image build against the JAX package: the plain PyTorch
version (what CPU tensors run; the CUDA kernel is held against it on the
card) equals JAX's XLA one-hot build, in bf16 and int8, and the Pallas
kernel in interpret mode, exactly.  The inputs cover masked thetas, beams
dropped as row -1, in-range rows with out-of-crop columns, and one cell
with 200 hits."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu.ops import csm_pallas
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, hit_images_cuda
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, B, CR, CC = 7, 320, 40, 48


def _inputs(seed, pile):
    """Crop cells with ~10% of the columns and rows off the crop, a random
    beam mask, two masked thetas, and ``pile`` beams of theta 3 in one
    cell."""
    rng = np.random.default_rng(seed)
    hr = rng.integers(-4, CR + 4, (T, B)).astype(np.int32)
    hc = rng.integers(-4, CC + 4, (T, B)).astype(np.int32)
    valid = rng.uniform(size=(T, B)) < 0.85
    # in-range rows whose column is off the crop, marked valid: the column
    # bound alone must drop them
    hr[1, :20] = rng.integers(0, CR, 20)
    hc[1, :20] = CC + rng.integers(0, 5, 20)
    valid[1, :20] = True
    hr[3, :pile], hc[3, :pile], valid[3, :pile] = 17, 29, True
    theta_mask = np.ones(T, bool)
    theta_mask[[0, 5]] = False
    return hr, hc, valid, theta_mask


def _port(hr, hc, valid, theta_mask):
    return csm.build_hit_images(
        *(torch.as_tensor(a) for a in (hr, hc, valid, theta_mask)),
        crop_rows=CR, crop_cols=CC,
    ).numpy()


@pytest.mark.parametrize("dtype,pile", [("bf16", 200), ("int8", 100)])
def test_plain_build_equals_xla_build(dtype, pile):
    """bf16 counts are exact to 256, int8 to 127: each case stays inside
    its type's range, and the bound is asserted on the inputs."""
    hr, hc, valid, theta_mask = _inputs(1, pile)
    ok = torch.as_tensor(valid & theta_mask[:, None])
    mult = int(csm.max_hit_multiplicity(torch.as_tensor(hr), torch.as_tensor(hc),
                                        ok, crop_cols=CC))
    assert mult == pile <= (256 if dtype == "bf16" else 127)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.int8
    ref = np.asarray(jcsm.build_hit_images(
        jnp.asarray(hr), jnp.asarray(hc), jnp.asarray(valid),
        jnp.asarray(theta_mask), crop_rows=CR, crop_cols=CC, dtype=jdt,
    ).astype(jnp.float32))
    got = _port(hr, hc, valid, theta_mask)
    assert got.dtype == np.float32 and got.shape == (T, CR, CC)
    np.testing.assert_array_equal(got, ref)
    assert got[3, 17, 29] >= pile
    assert not got[[0, 5]].any()


def test_plain_build_equals_pallas_interpret():
    hr, hc, valid, theta_mask = _inputs(2, 200)
    ok = valid & theta_mask[:, None]
    ref = np.asarray(csm_pallas.build_hit_images(
        jnp.asarray(np.where(ok, hr, -1)), jnp.asarray(np.where(ok, hc, -1)),
        crop_rows=CR, crop_cols=CC, interpret=True,
    ).astype(jnp.float32))
    np.testing.assert_array_equal(_port(hr, hc, valid, theta_mask), ref)


def test_counts_stay_exact_above_the_bf16_range():
    """The port's f32 counts are exact at any multiplicity: 600 beams in
    one cell count 600 (bf16 would round)."""
    rows = torch.full((2, 600), 5, dtype=torch.int32)
    cols = torch.full((2, 600), 9, dtype=torch.int32)
    rows[1, 300:] = -1
    out = csm.hit_images(rows, cols, crop_rows=8, crop_cols=12)
    assert out[0, 5, 9] == 600 and out[1, 5, 9] == 300
    assert out.sum() == 900


@pytest.mark.parametrize("case", ["i64_rows", "shape", "1d", "zero_crop"])
def test_build_rejects_what_the_kernel_does_not_take(case):
    rows = torch.zeros((3, 16), dtype=torch.int32)
    cols = torch.zeros((3, 16), dtype=torch.int32)
    kw = dict(crop_rows=8, crop_cols=8)
    if case == "i64_rows":
        rows = rows.long()
    elif case == "shape":
        cols = cols[:, :8]
    elif case == "1d":
        rows, cols = rows[0], cols[0]
    else:
        kw["crop_cols"] = 0
    with pytest.raises(ValueError):
        csm.hit_images(rows, cols, **kw)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only; there is no plain
    fallback behind it, and a refused call counts no launch."""
    rows = torch.zeros((2, 4), dtype=torch.int32)
    before = hit_images_cuda.LAUNCHES
    with pytest.raises(ValueError):
        hit_images_cuda.hit_images(rows, rows, crop_rows=4, crop_cols=4)
    assert hit_images_cuda.LAUNCHES == before
