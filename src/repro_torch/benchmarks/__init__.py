"""The port's copies of the reference's benchmark scripts.

`paper_tables` reproduces the paper's Tables II-XII and Figures 5-6 on a
named device (``python -m repro_torch.benchmarks.paper_tables --only
table2_hcd_ranges --device cpu``), writing its JSON under
`chiprun_out/paper_tables/`; `alpha_delta` compares the port's Table 11
plans with the committed goldens under `benchmarks/results/`, which it
only reads.
"""
