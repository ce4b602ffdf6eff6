"""The largest torch.cuda.max_memory_allocated() of any job (the peak is
reset before each job), in GiB."""


def read(record):
    peaks = [j["peak_bytes"] for j in record["jobs"]
             if j["peak_bytes"] is not None]
    return max(peaks) / 2 ** 30 if peaks else None
