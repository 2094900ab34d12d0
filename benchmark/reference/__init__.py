"""Plain references of the benchmark's configurations, one file each
(``<config>.py``), built on the shared modules of ``plain/``. They import
neither the port, nor JAX, nor the JAX package; ``core.reference_imports``
checks it at every run."""
