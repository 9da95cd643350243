"""Tests of the port that need the card.  They import no JAX (the card's
machine has none) and skip without a GPU.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda

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
    win = torch.as_tensor(rng.integers(0, 256, (N, 2, in_r, in_c)).astype(np.uint8))
    return win, hr, hc, ok


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
    off = csm.grid_offsets(ny, nx, stride, "cpu")
    ref = csm.sweep_plain(win, hr, hc, ok, off)
    before = csm_cuda.LAUNCHES
    out = csm.sweep(*[a.to(cuda_device) for a in (win, hr, hc, ok, off)])
    torch.cuda.synchronize(cuda_device)
    assert csm_cuda.LAUNCHES == before + 1
    assert torch.equal(out.cpu(), ref)


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(1)
    win, hr, hc, ok = [a.to(cuda_device) for a in _inputs(rng, 1, 4, 64, 32, 36, 36)]
    off = csm.grid_offsets(5, 5, 1, cuda_device)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.transpose(1, 2).contiguous().transpose(1, 2),
                           hc, ok, off)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.cpu(), hc, ok, off)
    with pytest.raises(ValueError):  # one channel: the kernel reads two
        csm_cuda.csm_sweep(win[:, :1].contiguous(), hr, hc, ok, off)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr.long(), hc, ok, off)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win.float(), hr, hc, ok, off)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr, hc, ok.to(torch.uint8), off)
    with pytest.raises(ValueError):  # hr's batch differs from win's
        csm_cuda.csm_sweep(win, torch.cat([hr, hr]), hc, ok, off)
    with pytest.raises(ValueError):
        csm_cuda.csm_sweep(win, hr, hc, ok, off.long())
