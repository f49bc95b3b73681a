"""The bit packing of the fused tracker's dense init batches
(runtime/sequence_tracker.py's pack_bits and unpack_bits) against numpy's
packbits / unpackbits and frtm_tpu's unpack_bits."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from frtm_tpu.models import aug_compose as jc
from frtm_tpu_torch.runtime.sequence_tracker import pack_bits, unpack_bits


@pytest.mark.parametrize("width", [1, 7, 9, 13, 64, 107])
def test_bit_packing_matches_numpy(width):
    rng = np.random.RandomState(width)
    bits = (rng.rand(3, 5, width) > 0.5).astype(np.uint8)
    packed = np.packbits(bits, axis=-1)
    np.testing.assert_array_equal(pack_bits(torch.from_numpy(bits)).numpy(), packed)
    got = unpack_bits(torch.from_numpy(packed), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.unpackbits(packed, axis=-1)[..., :width])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.unpack_bits(jnp.asarray(packed),
                                                                          width)))
