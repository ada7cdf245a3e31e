"""The port's encode_blocks_lanes byte-equal to the JAX package's, whose
Pallas kernels run in interpret mode on the CPU, at one level of each
codeword family (fastLZ4 11, LIZv1 25 with the far table, fastLZ4 + Huff0
35). Tolerance 0."""

import pytest

import lizard_tpu.ops.enc_lanes as J
from lizard_tpu.ref.block_decode import decompress as ref_decompress
import lizard_tpu_torch.ops.enc_lanes as P
from tests.test_enc_lanes import _mk_blocks, _mk_far_blocks
from tests.test_torch_enc_maps import port_cfg
from tests.test_torch_enc_parse import small_cfg
from tests.torch_cases import one_thread  # noqa: F401


# levels of the three codeword families, each with a tier that keeps the
# interpret-mode Pallas run short: 2 KB blocks, the far table 1 KB late, at
# most one h5 table
PIPELINE = {11: {}, 25: dict(k5=0), 35: dict(k5=1, lazy=1)}


@pytest.mark.parametrize("level", sorted(PIPELINE))
def test_encode_blocks_equals_pallas_pipeline(level):
    """Byte-equal to the JAX package's encode_blocks_lanes with its Pallas
    kernels in interpret mode."""
    jcfg = small_cfg(level, n=2048, far_dist=1024, **PIPELINE[level])
    blocks = [b[:2048] for b in _mk_blocks(level)]
    x = _mk_far_blocks(level)[4][:1500]               # random bytes
    blocks[7] = x + x[:548]                           # repeats 1500 back
    want = J.encode_blocks_lanes(blocks, level=level, cfg=jcfg,
                                 interpret=True)
    got = P.encode_blocks_lanes(blocks, level=level, cfg=port_cfg(jcfg),
                                device="cpu")
    assert got == want
    for d, e in zip(blocks, got):
        assert bytes(ref_decompress(e, max_out=max(len(d), 1))) == d
