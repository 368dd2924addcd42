"""``rank_select_kernel`` (``csrc/rank_select.cu``), one call on one
shard: the shard's rows read once (4 B code, 1 B live flag), the m
ranges and the batch of int32 ranks read, the int32 rows and the count
written."""


def counts(config: dict, cell: dict) -> dict:
    n_local = (1 << config["capacity_log2"]) // config["shards"]
    return {"bytes": n_local * 5 + config["m"] * 8 + cell["batch"] * 8 + 4,
            "flops": 0}
