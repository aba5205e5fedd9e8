"""PyTorch and CUDA port of the DC-SVM solver (see README.md).

The package imports ``torch`` and numpy only.  Its entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
