"""The port's data path against the JAX package's: the synthetic corpora,
the byte tokenizer, packing, loss masks and batching give the same arrays
from the same seed, bit for bit (integers: compared exactly), stats
included; the feed (``TrainPipeline``) on the CPU hands out those batches as
tensors, and keeps the reference's ``close``/drain guarantees
(tests/test_train_and_data.py). The feed's CUDA path (pinned memory, a side
stream, the consumer's wait on its event) runs on the card only:
``chip_smoke.py``'s train phase holds its batches against the host's."""
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_corpus_and_batches_equal(seed):
    assert tsyn.synthetic_corpus(40, 30, seed) == jsyn.synthetic_corpus(40, 30, seed)
    _same_batches(list(itertools.islice(tsyn.synthetic_batches(500, 3, 16, seed), 4)),
                  list(itertools.islice(jsyn.synthetic_batches(500, 3, 16, seed), 4)))


def test_tokenize_pack_and_mask_equal():
    assert tpipe.VOCAB == jpipe.VOCAB and (tpipe.BOS, tpipe.EOS, tpipe.PAD) == (
        jpipe.BOS, jpipe.EOS, jpipe.PAD)
    for text in ("hello", "", "naïve ☃ text", "a" * 7):
        np.testing.assert_array_equal(tpipe.byte_tokenize(text), jpipe.byte_tokenize(text))
        assert tpipe.byte_tokenize(text).dtype == np.int32
    docs = [tpipe.byte_tokenize(d) for d in tsyn.synthetic_corpus(30, 20, 1)]
    for seq_len in (8, 31, 64, 10_000):
        ts, js = {}, {}
        rows = tpipe.pack_sequences(docs, seq_len, stats=ts)
        want = jpipe.pack_sequences(docs, seq_len, stats=js)
        assert rows.dtype == want.dtype
        np.testing.assert_array_equal(rows, want)
        assert ts == js
        np.testing.assert_array_equal(tpipe.loss_mask_for(rows[:, 1:]),
                                      jpipe.loss_mask_for(want[:, 1:]))


@pytest.mark.parametrize("batch,epochs,seed", [(4, 2, 0), (3, 3, 7), (16, 1, 1)])
def test_batches_from_rows_equal(batch, epochs, seed):
    docs = [tpipe.byte_tokenize(d) for d in tsyn.synthetic_corpus(12, 10, 2)]
    rows = tpipe.pack_sequences(docs, 16)
    ts, js = {}, {}
    _same_batches(list(tpipe.batches_from_rows(rows, batch, seed=seed, epochs=epochs,
                                               stats=ts)),
                  list(jpipe.batches_from_rows(rows, batch, seed=seed, epochs=epochs,
                                               stats=js)))
    assert ts == js


def test_pipeline_hands_out_the_host_batches_as_cpu_tensors():
    rows = tpipe.pack_sequences([tpipe.byte_tokenize("document %d " % i * 4)
                                 for i in range(20)], 16)
    want = list(jpipe.batches_from_rows(rows, 4, seed=5, epochs=2))
    pipe = tpipe.TrainPipeline(tpipe.batches_from_rows(rows, 4, seed=5, epochs=2),
                               device="cpu")
    got = list(pipe)
    pipe.close()
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in got for t in b.values())
    _same_batches([{k: t.numpy() for k, t in b.items()} for b in got], want)


def test_pipeline_close_returns_with_full_queue():
    """The reference's regression: a stopped consumer with a FULL bounded
    queue must not wedge ``close()``."""

    def endless():
        i = 0
        while True:
            yield {"tokens": np.full((2, 2), i, np.int32)}
            i += 1

    pipe = tpipe.TrainPipeline(endless(), device="cpu", depth=2)
    next(pipe)
    deadline = time.monotonic() + 2.0
    while not pipe._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pipe._q.full()
    t0 = time.monotonic()
    pipe.close()
    assert time.monotonic() - t0 < 5.0
    assert not pipe._thread.is_alive()


def test_pipeline_drains_finite_iterator():
    rows = np.arange(40, dtype=np.int32).reshape(8, 5)
    pipe = tpipe.TrainPipeline(tpipe.batches_from_rows(rows, batch=4, epochs=1),
                               device="cpu", depth=2)
    got = list(pipe)
    assert len(got) == 2
    pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_defaults_to_the_card():
    """An entry point runs on ``cuda`` unless asked: without a card the
    default feed raises instead of staging on the CPU."""
    if torch.cuda.is_available():
        pipe = tpipe.TrainPipeline(iter([]))
        assert list(pipe) == [] and pipe._stream is not None
        pipe.close()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tpipe.TrainPipeline(iter([]))
