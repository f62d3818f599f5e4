"""Models of the port: the UNet plan, eager and kernel-fused forwards,
weight carry-over and loading."""
