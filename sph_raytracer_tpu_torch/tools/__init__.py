"""On-card studies of the port's kernels, run as modules
(``python -m sph_raytracer_tpu_torch.tools.<name>``)."""
