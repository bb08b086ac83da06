"""Site sharding on ``torch.distributed`` (the site helpers of
``repro.parallel``; its LM partition rules belong to the LM stack)."""
from repro_torch.parallel.sharding import (SiteGroup, SiteShard,
                                           pad_site_axis, site_group,
                                           site_pad)

__all__ = ["SiteGroup", "SiteShard", "pad_site_axis", "site_group",
           "site_pad"]
