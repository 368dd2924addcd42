"""A request's priority writes: the drawn rows (int32) and their float32
priorities read and each row's code and live flag written (5 B), then
the inserted rows' codes and flags written from one maximum."""


def counts(config: dict, cell: dict) -> dict:
    b, ins = cell["batch"], cell["inserts"]
    return {"bytes": b * (4 + 4 + 5) + 4 + ins * 5, "flops": 0}
