"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions."""
# Import order: the core imports ``ops`` (digests and parity), and the
# kernels' build guard is a ``repro_torch.core.concurrency`` lock, so the
# core loads first whichever module a caller imports first.
import repro_torch.core  # noqa: F401
