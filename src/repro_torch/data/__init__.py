"""The training data path: byte tokenizer, sequence packing, batching and
the double-buffered host→device feed (the port of ``repro.data``)."""
from repro_torch.data.pipeline import TrainPipeline, byte_tokenize, pack_sequences  # noqa: F401
from repro_torch.data.synthetic import synthetic_corpus, synthetic_batches  # noqa: F401
