"""The language models of the serving path: the ten assigned
architectures' inference (``model``), their layers and the serve/eval
steps, in plain PyTorch on tensors."""
