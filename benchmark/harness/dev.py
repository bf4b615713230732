"""The device a run drives: the card in every benchmark run; the CPU only in
the harness's own tests, which drive a run without a chip."""

from __future__ import annotations

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def name(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
