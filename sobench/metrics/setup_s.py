"""Set-up seconds: from the process's start to the window's (imports,
the kernels' build or load, the snapshots made on the device and copied to
the host, the warm-up)."""


def read(record):
    return record["setup_s"]
