"""pano_tpu_torch.timer.fetch_image on the CPU: what comes back for numpy
arrays and CPU tensors, and the refusal of other devices. The pinned
route of CUDA tensors is tested on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pano_tpu_torch import timer  # noqa: E402


def test_numpy_array_comes_back_as_itself():
    a = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    assert timer.fetch_image(a) is a


@pytest.mark.parametrize("shape,dtype", [
    ((5, 7, 3), torch.uint8),          # small
    ((1100, 2600, 3), torch.uint8),    # over the pinned route's 8 MiB
    ((64, 48), torch.float32),
    ((), torch.float32),               # 0-d
])
def test_cpu_tensor_comes_back_equal(shape, dtype):
    g = torch.Generator().manual_seed(3)
    t = (torch.randint(0, 256, shape, generator=g, dtype=dtype)
         if dtype == torch.uint8 else torch.randn(shape, generator=g))
    got = timer.fetch_image(t)
    assert isinstance(got, np.ndarray)
    assert got.shape == tuple(shape) and got.dtype == t.numpy().dtype
    np.testing.assert_array_equal(got, t.numpy())


@pytest.mark.parametrize("shape", [(4, 5, 3), ()])
def test_other_devices_raise(shape):
    x = torch.empty(shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        timer.fetch_image(x)

