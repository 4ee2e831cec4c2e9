"""The plain reference the port is held to: plain PyTorch, float32, TF32 off; it imports nothing of the port."""
