"""PyTorch port, ``Trainer.export`` of a tiny CAM++ (all 52 layers, the
stride-2 stem and the CAM context segments over a symbolic length)
against the JAX backbone's forward: ``check_export`` of
``tests/test_torch_export.py``, in a file of its own because its export,
save and load take about a minute on the CPU."""

import pytest
import torch

from test_torch_export import check_export
from test_torch_helpers import speaker_corpus


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["CAMPPlus"])
def test_export_matches_jax(tmp_path, name):
    lists = speaker_corpus(tmp_path / "corpus", n_utts=2)
    check_export(lists, tmp_path, name)
