"""Distribution of the port: the logical-axis sharding rules, int8
gradient compression for the data-parallel all-reduce and the GPipe
pipeline, on ``torch.distributed``."""
