"""chunk_ms.train: mean host milliseconds of a ``ChunkLoader.get_chunk``
call in the window (the harness's span around each call)."""


def read(r):
    s = r["host"].get("get_chunk")
    return sum(s) / len(s) * 1e3 if s else None
