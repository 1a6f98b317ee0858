"""The benchmark's plain fp32 reference: networks, operations and training
steps in plain PyTorch. It imports nothing of the program under test."""
