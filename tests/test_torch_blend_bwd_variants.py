"""gsjax_torch: the backward variants tools/blend_bwd_variants.py builds
edit csrc/blend.cuh as each one says (the first two are cases in
test_torch_blend_bwd.py)."""

import pytest

from test_torch_blend_bwd_common import BWD_VARIANTS, check_bwd_variant_edits_the_kernel


@pytest.mark.parametrize("variant", BWD_VARIANTS[2:])
def test_blend_bwd_variants_edit_the_kernel(variant):
    check_bwd_variant_edits_the_kernel(variant)
