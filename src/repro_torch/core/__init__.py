"""Core binarization library, in PyTorch."""
