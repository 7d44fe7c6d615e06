"""ya_vo_tpu_torch: the visual-odometry pipeline in PyTorch, with hand-written
CUDA kernels for Hopper (see README.md, "PyTorch / H100 port").

It imports no JAX and nothing of the JAX package: the numpy modules it needs
(`config`, `worldmap/mapstore`, `viz/evaluation`) are its own copies.
"""

from ya_vo_tpu_torch.config import VOConfig  # noqa: F401


def create_frontend(config=None, camera=None, device=None):
    """Build a ready-to-run VO frontend on `device` (default: the CUDA card;
    raises when there is none; pass device="cpu" to run the plain versions
    on the CPU).

    Args:
      config: VOConfig (defaults to KITTI-shaped defaults).
      camera: core.camera.Camera (defaults to KITTI gray-cam intrinsics).
      device: torch device for the tracking state and kernels.
    """
    from ya_vo_tpu_torch.tracking.frontend import Frontend
    from ya_vo_tpu_torch.utils.synthetic import kitti_camera

    return Frontend(config or VOConfig(), camera or kitti_camera(),
                    device=device)


def require_device(device="cuda"):
    """`device` as a torch.device; raises on a CUDA device where there is
    none (the tools run on the card unless asked for the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card by "
                           "default; pass --device cpu to run on the CPU")
    return device
