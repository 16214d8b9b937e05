"""Copy of karpenter_tpu/controllers/__init__.py, imports rewritten to the port's."""
