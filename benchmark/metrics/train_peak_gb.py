"""The most device memory the allocator held during the window
(`torch.cuda.max_memory_allocated`, reset at the window's start), in GB
(1e9 bytes): what decides the batch a card holds."""

NAME, UNIT, KIND, KINDS = "train_peak_gb", "GB", "end_to_end", ("train_step",)


def read(record):
    return record["peak_bytes"] / 1e9 if record["peak_bytes"] else None
