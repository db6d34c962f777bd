from repro_torch.models.rgat import rgat, rgat_program    # noqa: F401

# the DSL ModelSpecs, keyed as the drivers' --model flag expects. RGCN, HGT
# and rgcn_cat join once their aggregation kernel is ported.
DSL_MODELS = {"rgat": rgat}
