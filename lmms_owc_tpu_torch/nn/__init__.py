"""The port's model stack: ``nn.Module``s and functions on tensors."""
