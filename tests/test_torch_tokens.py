"""The port's LM token stream against the JAX package's, on the CPU.

``host_batch`` (numpy in both packages) is bitwise the reference's; the
``TokenStream`` draws from torch's generator seeded from (seed, step),
not JAX's threefry stream, so its batches are held to the reference's
structure instead: a state round trip replays the stream bit for bit,
every third token is (t−2 + t−1) mod V, ids lie in [0, V), targets are
the tokens shifted by one, and the unigram is Zipf-like (rank 0 the most
frequent).
"""
import numpy as np
import pytest
import torch

from repro.data import tokens as RTok
from repro_torch.data import tokens as TTok


@pytest.mark.parametrize("seed,step", [(0, 0), (17, 3), (5, 1 << 12)])
def test_host_batch_bitwise(seed, step):
    want = RTok.host_batch(997, 3, 12, seed, step)
    got = TTok.host_batch(997, 3, 12, seed, step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_stream_state_round_trip_bitwise():
    s1 = TTok.TokenStream(vocab=97, batch=2, seq=8, seed=3)
    for _ in range(3):
        s1.next_batch()
    st = s1.state()
    assert st == {"seed": 3, "step": 3}
    b_next = s1.next_batch()
    s2 = TTok.TokenStream.from_state(97, 2, 8, st)
    b_re = s2.next_batch()
    for k in ("tokens", "targets"):
        assert torch.equal(b_next[k], b_re[k])
    assert s2.state() == s1.state()
    other = TTok.TokenStream(vocab=97, batch=2, seq=8, seed=4, step=3)
    assert not torch.equal(other.next_batch()["tokens"], b_next["tokens"])


def test_stream_order2_rule_and_shapes():
    v, b, s = 1000, 8, 63
    stream = TTok.TokenStream(vocab=v, batch=b, seq=s, seed=17)
    counts = np.zeros(v, np.int64)
    for _ in range(4):
        out = stream.next_batch()
        toks, tgt = out["tokens"], out["targets"]
        assert toks.shape == tgt.shape == (b, s)
        assert toks.dtype == torch.int32
        full = torch.cat([toks, tgt[:, -1:]], dim=1)          # [b, s+1]
        assert torch.equal(full[:, 1:], tgt)
        assert int(full.min()) >= 0 and int(full.max()) < v
        for t in range(2, s + 1, 3):
            assert torch.equal(full[:, t], (full[:, t - 2] + full[:, t - 1])
                               % v)
        keep = np.arange(s + 1) % 3 != 2
        np.add.at(counts, full[:, keep].numpy().ravel(), 1)
    assert counts[0] == counts.max() and counts[0] > 10 * counts[v // 2]
