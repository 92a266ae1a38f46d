"""Kernel rooflines, one file a kernel, found by its id: ``<id>.py`` holds

- ``MODULE`` and ``ATTR``: the port function it wraps (a module
  attribute, swapped for the profiled slice only);
- ``KERNELS``: the base names of the device kernels a call launches;
- ``record(args, out)``: what a call needs for its bound, from its
  arguments by name and its output, or None to leave the call uncounted;
- ``bound_s(record)``: that call's roofline bound in seconds
  (``roofline.py``'s arithmetic).

``tracing.kernel_calls`` wraps every file's function, and a traced run's
``Run.rooflines`` holds each id's summed bound, device seconds and calls.
"""
