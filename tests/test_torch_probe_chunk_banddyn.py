"""gsjax_torch.tools.probe_chunk (J) against tools/probe_chunk.py: the
variants banddyn, gatherreal and dynread."""

import pytest

from gsjax_torch.tools import probe_chunk as tchunk

from test_torch_probe_common import CHUNK_KINDS, check_chunk_matches_probe


@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("variant", tchunk.VARIANTS[12:15])
def test_chunk_matches_probe(variant, kind):
    check_chunk_matches_probe(variant, kind)
