"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card.  These tests import no JAX, so they run on a machine with a card
and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card they skip (the kernels have no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels.iou_match.kernel import iou_matrix
from repro_torch.kernels.iou_match.ref import iou_ref
from repro_torch.kernels.thompson.kernel import thompson_choose
from repro_torch.kernels.thompson.ref import thompson_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("c,m", [(50, 22), (50, 1000), (7, 1025), (1, 1)])
def test_thompson_kernel_equals_plain(card, c, m):
    g = torch.Generator().manual_seed(c * 1000 + m)
    alpha = torch.rand(m, generator=g) * 20 + 0.05
    alpha[torch.rand(m, generator=g) < 0.3] = -1.0
    beta = torch.rand(m, generator=g) * 300 + 1
    z = torch.randn(c, m, generator=g)
    alpha, beta, z = alpha.to(card), beta.to(card), z.to(card)
    before = thompson_choose.launches
    ki, kv = thompson_choose(alpha, beta, z)
    ri, rv = thompson_ref(alpha, beta, z)
    assert thompson_choose.launches == before + 1
    assert torch.equal(ki, ri) and torch.equal(_bits(kv), _bits(rv))


def test_thompson_kernel_all_exhausted(card):
    alpha = torch.full((300,), -1.0, device=card)
    ki, kv = thompson_choose(alpha, torch.ones(300, device=card), torch.randn(4, 300, device=card))
    assert ki.tolist() == [-1] * 4
    assert torch.equal(kv, torch.full((4,), -1e30, dtype=torch.float32, device=card))


@pytest.mark.parametrize("d,r", [(16, 8192), (13, 1000), (1, 1), (40, 77)])
def test_iou_kernel_equals_plain(card, d, r):
    g = torch.Generator().manual_seed(d * 1000 + r)

    def boxes(k):
        xy = torch.rand(k, 2, generator=g) * 0.7
        b = torch.cat([xy, xy + torch.rand(k, 2, generator=g) * 0.2], 1)
        b[torch.rand(k, generator=g) < 0.2] = 0.0
        return b.to(card)

    a, b = boxes(d), boxes(r)
    assert torch.equal(_bits(iou_matrix(a, b)), _bits(iou_ref(a, b)))
