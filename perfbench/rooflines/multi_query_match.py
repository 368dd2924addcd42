"""``multi_query_match_kernel`` (``csrc/multi_query_match.cu``), one
call on one shard: the rows read once (4 B code, 1 B live flag), the m
ranges read, one bool a row and one int32 count a range written."""


def counts(config: dict, cell: dict) -> dict:
    n_local = (1 << config["capacity_log2"]) // config["shards"]
    return {"bytes": n_local * 6 + config["m"] * 12, "flops": 0}
