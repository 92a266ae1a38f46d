"""The plain references: straightforward path tracers in PyTorch, one
plain side a configuration family (``<family>.py``, found by
``port_bench.families``), and what they share (``tracer.py``, ``rng.py``).

None imports JAX or anything of the port. ``planar`` takes a scene
description (``port_bench.scenes.Description``), a key and the render's
sizes, builds its own intersection structures and traces the same
estimator the port states: camera rays, closest hits on quads and
triangles, emission, background, lambertian scatter with the one-sample
mixture of the cosine and light pdfs, and per-pixel accumulation. Its
random numbers follow the same specification (``rng.py``), so for one key
both sides trace the same paths and their images agree up to rounding.
"""
