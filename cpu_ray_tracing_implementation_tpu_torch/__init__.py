"""PyTorch/CUDA port of the path tracer in ``cpu_ray_tracing_implementation_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/ ops/ utils/``) and module names so each function has a findable
counterpart. Plain tensor code is PyTorch; the TPU's Pallas kernels become
hand-written CUDA kernels for Hopper (``csrc/``), built at first use by
``kernels/build.py``.

The package imports ``torch`` and ``numpy`` only, never ``jax``.
"""

__version__ = "0.1.0"
