"""pigeon_tpu_torch: the PyTorch/CUDA port of `pigeon_tpu`.

A batched coupled lateral+longitudinal tracking MPC for a fleet of
vehicles, written in PyTorch with hand-written CUDA kernels for NVIDIA
Hopper (`csrc/`, built by `_kernels.py`).  Module names mirror the JAX
package's, so each module's counterpart is easy to find; the port imports
nothing from `pigeon_tpu` and nothing of JAX.

Entry points (`mpc.init_carry`, `trajectory.make_tube`, `hji.make_cache`,
`hji.inactive_cache`) place their tensors on the card unless the caller
passes `device="cpu"`; everything downstream follows its inputs' device.
A kernel wrapper launches its CUDA kernel for a CUDA tensor and runs its
plain PyTorch version only for a CPU tensor.
"""

import torch

# The KKT matrix K = P + sigma I + A' rho A is assembled by a float32
# einsum (solver/lane_admm.py); TF32 would round its inputs to 10 bits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card; raises when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pigeon_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
