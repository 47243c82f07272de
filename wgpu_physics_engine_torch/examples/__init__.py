"""Examples of the port, run as modules
(``python -m wgpu_physics_engine_torch.examples.<name>``)."""
