"""PyTorch/CUDA port of the flying-serving system (one card)."""
