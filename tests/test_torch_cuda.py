"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

    python -m pytest -m cuda tests/test_torch_cuda.py     # on a machine with an H100

Each test asks the ``cuda`` fixture for the device; the fixture decides
whether a card and nvcc are present when the test runs, never at import, so
every pytest-xdist worker collects the same tests.  Without a card they skip.
This file imports no JAX: the plain PyTorch versions are the reference here.
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import quant as q
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _x(rows, cols, device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device=device)
    x[0].zero_()
    x[1, :3] = -0.0
    return x


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("rows,cols", [(37, 128), (64, 1024), (9, 512)])
def test_quantize_pack_kernel_bit_equal(cuda, bits, rows, cols):
    x = _x(rows, cols, cuda, seed=bits)
    before = q.quantize_pack_2d.launches
    words, scale = q.quantize_pack_2d(x, 0xABCDEF ^ bits, bits=bits)
    torch.cuda.synchronize()
    assert q.quantize_pack_2d.launches == before + 1
    w_ref, s_ref = ref.quantize_pack_2d_ref(x, 0xABCDEF ^ bits, bits=bits)
    assert torch.equal(words, w_ref) and torch.equal(scale, s_ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("acc_weight,weight", [(1.0, 1.0), (-1.0, 2.0), (0.5, 1.0 / 3.0)])
def test_unpack_dequant_axpy_kernel_bit_equal(cuda, bits, acc_weight, weight):
    x = _x(40, 256, cuda, seed=bits)
    acc = _x(40, 256, cuda, seed=100 + bits)
    words, scale = q.quantize_pack_2d(x, 5, bits=bits)
    out = q.unpack_dequant_axpy_2d(words, scale, acc, bits=bits, weight=weight,
                                   acc_weight=acc_weight)
    want = ref.unpack_dequant_axpy_2d_ref(words, scale, acc, bits=bits, weight=weight,
                                          acc_weight=acc_weight)
    assert torch.equal(out, want)
    q.unpack_dequant_axpy_2d(words, scale, acc, bits=bits, weight=weight,
                             acc_weight=acc_weight, out=acc)     # in place
    assert torch.equal(acc, want)


def test_wire_dcd_round_on_card_matches_cpu(cuda):
    """One stacked quant:4 encode + in-place decode on the card equals the
    CPU's (plain versions), words and floats."""
    from repro_torch.distributed.wire import QuantWire

    wire = QuantWire(bits=4, block=1024)
    leaf = _x(8, 3000, cuda, seed=3).reshape(8, 1, 3000) * 0.01
    acc = _x(8, 3000, cuda, seed=4).reshape(8, 1, 3000)
    p_gpu = wire.encode(leaf, 77)
    p_cpu = wire.encode(leaf.cpu(), 77)
    assert torch.equal(p_gpu["codes"].cpu(), p_cpu["codes"])
    assert torch.equal(p_gpu["scale"].cpu(), p_cpu["scale"])
    a_cpu = acc.cpu()
    wire.decode_axpy_(p_gpu, acc, 2.0, -1.0)
    wire.decode_axpy_(p_cpu, a_cpu, 2.0, -1.0)
    assert torch.equal(acc.cpu(), a_cpu)
