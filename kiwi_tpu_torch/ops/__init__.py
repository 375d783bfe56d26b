"""The port's CUDA kernels and their plain PyTorch versions."""

import torch


def refuse_grad(name, *tensors):
    """Raise if autograd would record `name`'s call: no kernel of the port
    has a backward (neither has its TPU counterpart), and a launch would
    give a silent zero gradient.  Differentiate the plain formulation
    (Engine's forward_batch_xla), as the JAX package differentiates XLA."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad(), or "
                           "differentiate the plain-torch formulation")
