"""Entry points of the port: the trainer (``python -m
repro_torch.launch.train``) and the meshes (``launch.mesh``)."""
