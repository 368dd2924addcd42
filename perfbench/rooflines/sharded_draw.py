"""One sharded AMPER-fr draw of the whole table, whatever the kernels:
every row's code and live flag read once (5 B a row: 1.342 GB for 2^28
rows, 0.40 ms at 3.35 TB/s) and the batch of int32 global rows
written."""


def counts(config: dict, cell: dict) -> dict:
    return {"bytes": (1 << config["capacity_log2"]) * 5 + cell["batch"] * 4,
            "flops": 0}
