"""Sharding on ``torch.distributed`` (port of ``repro.parallel``): the
fleet's site helpers, and the LM stack's partition rules over a mesh of
ranks (``sharding``) with their collectives (``collectives``)."""
from repro_torch.parallel.sharding import (ACTIVATION_RULES, LMShards,
                                           SiteGroup, SiteShard,
                                           mesh_context, pad_site_axis,
                                           param_partition_spec, site_group,
                                           site_pad, tree_pspecs)

__all__ = ["ACTIVATION_RULES", "LMShards", "SiteGroup", "SiteShard",
           "mesh_context", "pad_site_axis", "param_partition_spec",
           "site_group", "site_pad", "tree_pspecs"]
