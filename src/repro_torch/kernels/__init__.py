"""The port's kernels: CUDA sources (`csrc/`), their build (`build.py`),
wrappers with launch counts (`ops.py`) and plain PyTorch versions
(`ref.py`)."""
