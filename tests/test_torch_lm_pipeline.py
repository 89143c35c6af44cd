"""The port's LM token pipeline (``repro_torch.data.lm_pipeline``) against
the JAX package's (``repro.data.lm_pipeline``): every batch equal bit for
bit for any ``(seed, step, n_hosts, host_id)``, the cursor's state
round-tripping, and the port's copy importing neither package's JAX code.
"""
import numpy as np
import pytest

from repro.data import lm_pipeline as ref
from repro_torch.data import lm_pipeline as port

CASES = [  # vocab, seq_len, global_batch, seed, n_hosts, host_id, mean_doc_len
    (512, 32, 4, 1, 1, 0, 256),
    (512, 128, 8, 0, 1, 0, 256),
    (128256, 128, 8, 1, 2, 1, 256),
    (1000, 64, 12, 7, 3, 2, 16),
    (50, 17, 6, 3, 2, 0, 8),
]


@pytest.mark.parametrize("case", CASES)
def test_batches_equal_reference(case):
    vocab, seq, gb, seed, hosts, host, doc = case
    a = ref.SyntheticLM(vocab, seq, gb, seed=seed, n_hosts=hosts, host_id=host, mean_doc_len=doc)
    b = port.SyntheticLM(vocab, seq, gb, seed=seed, n_hosts=hosts, host_id=host, mean_doc_len=doc)
    for step in (0, 1, 5, 1000):
        want, got = a.batch_at(step), b.batch_at(step)
        assert set(got) == set(want) == {"tokens", "loss_mask"}
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (k, step)
    for _ in range(3):   # the stream, step by step
        want, got = next(iter(a)), next(iter(b))
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert b.state_dict() == a.state_dict() == {"seed": seed, "step": 3}


def test_state_dict_round_trips_across_packages():
    """A cursor saved by either package resumes the other's stream where it
    stopped (the checkpoint manifest carries it)."""
    a = ref.SyntheticLM(512, 32, 4, seed=1)
    for _ in range(4):
        a.next_batch()
    b = port.SyntheticLM(512, 32, 4, seed=99)
    b.load_state_dict(a.state_dict())
    assert b.state == port.PipelineState(seed=1, step=4)
    assert np.array_equal(b.next_batch()["tokens"], a.next_batch()["tokens"])
    c = ref.SyntheticLM(512, 32, 4, seed=5)
    c.load_state_dict(b.state_dict())
    assert np.array_equal(c.next_batch()["tokens"], b.next_batch()["tokens"])


def test_hosts_partition_the_global_batch():
    """Each host draws its own rows; a batch that does not split raises."""
    rows = [port.SyntheticLM(512, 32, 8, seed=2, n_hosts=2, host_id=h).batch_at(0)["tokens"]
            for h in (0, 1)]
    assert rows[0].shape == (4, 32) and not np.array_equal(rows[0], rows[1])
    with pytest.raises(ValueError):
        port.SyntheticLM(512, 32, 7, n_hosts=2)
