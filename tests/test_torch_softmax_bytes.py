"""The bytes an ELL softmax needs (``segment_softmax.ell_softmax_bytes``),
the bound of its kernel: every slot's mask byte and output, and the score
of each real slot only.  Exact integers on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.graph import structure as TS
from repro_torch.kernels import segment_softmax as TSS

# an empty row, a full row and a partly real (non-prefix) row
_MASK = [[0, 0, 0, 0, 0, 0],
         [1, 1, 1, 1, 1, 1],
         [0, 1, 0, 0, 1, 0]]


@pytest.mark.parametrize("dtype, want", [
    (torch.float32, 18 * (1 + 4) + 8 * 4),
    (torch.bfloat16, 18 * (1 + 2) + 8 * 2),
])
def test_bytes_of_a_hand_made_mask(dtype, want):
    mask = torch.tensor(_MASK, dtype=torch.bool)
    got = TSS.ell_softmax_bytes(mask, dtype)
    assert type(got) is int and got == want


@pytest.mark.parametrize("dtype, itemsize", [(torch.float32, 4),
                                             (torch.bfloat16, 2)])
def test_full_and_empty_masks_bound_the_count(dtype, itemsize):
    """A full mask needs every slot's score (the all-slot count); an empty
    one needs none."""
    full = torch.ones((5, 48), dtype=torch.bool)
    assert TSS.ell_softmax_bytes(full, dtype) == 5 * 48 * (1 + 2 * itemsize)
    empty = torch.zeros((5, 48), dtype=torch.bool)
    assert TSS.ell_softmax_bytes(empty, dtype) == 5 * 48 * (1 + itemsize)
    assert TSS.ell_softmax_bytes(torch.zeros((0, 48), dtype=torch.bool),
                                 dtype) == 0


def test_bytes_of_an_in_layout():
    """The count on a blocked-ELL in-layout: its real slots are the graph's
    edges."""
    g = TS.rmat_graph(400, 3200, seed=11, device="cpu")
    e = TS.to_blocked_ell(g)
    mask = e.mask.numpy()
    real = int(np.count_nonzero(mask))
    assert real == g.num_edges
    assert TSS.ell_softmax_bytes(e.mask, torch.float32) == \
        mask.size * 5 + real * 4
