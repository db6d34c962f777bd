from repro_torch.models.rgcn import rgcn, rgcn_program          # noqa: F401
from repro_torch.models.rgat import rgat, rgat_program          # noqa: F401
from repro_torch.models.hgt import hgt, hgt_program             # noqa: F401
from repro_torch.models.zoo import rgcn_cat, rgcn_cat_program   # noqa: F401

# the DSL ModelSpecs, keyed as the drivers' --model flag expects
DSL_MODELS = {"rgcn": rgcn, "rgat": rgat, "hgt": hgt, "rgcn_cat": rgcn_cat}
