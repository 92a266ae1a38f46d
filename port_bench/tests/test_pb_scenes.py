"""The frozen colonnade hall of the CPU tests, pinned."""

import hashlib

import numpy as np

from port_bench.scenes import colonnade_hall as colonnade

# sha256 of the float32 bytes of colonnade_hall() (target 260,000, seed 14)
CHECKSUM = "e897609757e60257"


def test_colonnade_is_pinned():
    v = colonnade.colonnade_hall()
    assert v.shape == (257_916, 3, 3) and v.dtype == np.float32
    assert hashlib.sha256(v.tobytes()).hexdigest()[:16] == CHECKSUM


def test_colonnade_matches_the_port_generator_at_a_small_size():
    from cpu_ray_tracing_implementation_tpu_torch.utils import procgen

    assert np.array_equal(colonnade.colonnade_hall(3000), procgen.colonnade_hall(3000))
