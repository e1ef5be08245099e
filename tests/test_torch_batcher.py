"""The port's host-side ``RequestBatcher`` (``repro_torch.serve.batcher``)
against the JAX package's ``repro.serve.batcher.RequestBatcher``: the
reference's four cases (``tests/test_fault_tolerance.py``) on the port,
and a property over random submit and ``next_batch`` sequences holding
every batch's four arrays, ``ready()``, ``stats``, ``occupancy`` and
``padding_fraction`` equal."""
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve.batcher import RequestBatcher as JBatcher
from repro_torch.serve import RequestBatcher


def test_batcher_padding_and_order():
    b = RequestBatcher(batch_size=4)
    b.submit([10, 11, 12], [0, 0, 1], cohort=0)
    assert b.ready()
    batch = b.next_batch()
    assert batch.frame_ids.tolist() == [10, 11, 12, -1]
    assert batch.valid.tolist() == [True, True, True, False]
    assert b.occupancy == 0.75


def test_batcher_never_blocks_on_stragglers():
    b = RequestBatcher(batch_size=4, max_wait_rounds=0)
    b.submit([1], [0], cohort=0)
    assert b.ready()                      # a partial batch goes at once
    batch = b.next_batch()
    assert batch.valid.sum() == 1


def test_batcher_padding_fraction_matches_hand_count():
    """The padding fraction equals the pads emitted, counted by hand over
    full, partial and singleton batches."""
    b = RequestBatcher(batch_size=4, max_wait_rounds=0)
    assert b.padding_fraction() == 0.0
    hand_pads, hand_slots = 0, 0
    for burst in ([5] * 4, [6] * 3, [7]):  # pads: 0, 1, 3
        b.submit(burst, [0] * len(burst), cohort=0)
        batch = b.next_batch()
        hand_pads += int((~batch.valid).sum())
        hand_slots += len(batch.valid)
    assert b.stats["padded_slots"] == hand_pads == 4
    assert b.padding_fraction() == hand_pads / hand_slots
    assert abs(b.padding_fraction() + b.occupancy - 1.0) < 1e-12


def test_batcher_ratio_stats_defined_before_any_batch():
    """0.0 padding and 1.0 occupancy before any batch, also after a
    ``next_batch`` that found the queue empty."""
    b = RequestBatcher(batch_size=4, max_wait_rounds=0)
    assert b.padding_fraction() == 0.0
    assert b.occupancy == 1.0
    assert b.next_batch() is None
    assert b.stats["batches"] == 0
    assert b.padding_fraction() == 0.0
    assert b.occupancy == 1.0


# an op: (0, n) submits n frames as one cohort, (1, _) calls next_batch
_OPS = st.lists(st.tuples(st.sampled_from([0, 1]), st.integers(0, 9)), min_size=0, max_size=30)


@settings(max_examples=60, deadline=None)
@given(batch_size=st.integers(1, 6), max_wait=st.integers(0, 3), ops=_OPS)
def test_batcher_equals_jax(batch_size, max_wait, ops):
    tb = RequestBatcher(batch_size, max_wait_rounds=max_wait)
    jb = JBatcher(batch_size, max_wait_rounds=max_wait)
    frame = 0
    for i, (kind, n) in enumerate(ops):
        if kind == 0:
            frames = list(range(frame, frame + n))
            frame += n
            chunks = [f % 7 for f in frames]
            tb.submit(frames, chunks, cohort=i)
            jb.submit(frames, chunks, cohort=i)
        else:
            tbatch, jbatch = tb.next_batch(), jb.next_batch()
            assert (tbatch is None) == (jbatch is None)
            if jbatch is not None:
                for f in ("frame_ids", "chunk_ids", "valid", "cohorts"):
                    t, j = getattr(tbatch, f), getattr(jbatch, f)
                    assert t.dtype == j.dtype and t.shape == (batch_size,)
                    np.testing.assert_array_equal(t, j, err_msg=f)
        assert tb.ready() == jb.ready()
        assert tb.stats == jb.stats
        assert tb.occupancy == jb.occupancy
        assert tb.padding_fraction() == jb.padding_fraction()
