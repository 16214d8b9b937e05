"""Copy of karpenter_tpu/providers/launchtemplate/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.launchtemplate.provider import LaunchTemplateProvider, ResolvedTemplate

__all__ = ["LaunchTemplateProvider", "ResolvedTemplate"]
