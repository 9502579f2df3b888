"""What the tests share: the ``card`` fixture of the tests marked ``cuda``,
and, on a host without JAX (a card host has only the port), collection
that leaves out the files built on the JAX package, so that ``pytest -m
cuda tests/`` collects the card tests there. Where JAX is installed every
file is collected."""
import functools
import importlib
import re

import pytest
import torch

#: an import of the JAX package (or of jax itself) at a file's top level
_JAX_IMPORT = re.compile(r"^(import|from)\s+(jax|repro)\b", re.M)


@functools.cache
def _has_jax() -> bool:
    try:
        importlib.import_module("jax")
    except ImportError:
        return False
    return True


def pytest_ignore_collect(collection_path, config):
    if collection_path.suffix != ".py" or not collection_path.name.startswith("test_"):
        return None
    if _JAX_IMPORT.search(collection_path.read_text()) and not _has_jax():
        return True
    return None


@pytest.fixture
def card():
    """The CUDA device, f32 products in full f32 (TF32 off, as the kernels
    compute them); skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
