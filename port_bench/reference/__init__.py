"""The plain reference: a straightforward path tracer in PyTorch.

It imports neither JAX nor anything of the port. It takes a scene
description (``port_bench.scenes.Description``), a key and the render's
sizes, builds its own intersection structures and traces the same
estimator the port states: camera rays, closest hits on quads and
triangles, emission, background, lambertian scatter with the one-sample
mixture of the cosine and light pdfs, and per-pixel accumulation. Its
random numbers follow the same specification (``rng.py``), so for one key
both sides trace the same paths and their images agree up to rounding.
"""
