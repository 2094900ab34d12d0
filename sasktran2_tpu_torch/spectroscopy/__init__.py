"""Spectroscopy namespace (reference src/sasktran2/spectroscopy: empty
placeholder module).

(Copy of ``sasktran2_tpu/spectroscopy/__init__.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""
