"""Tiny-width contexts of the cells, for rehearsals on the CPU: every width
cut so that a whole run (set-up, window, judge) takes seconds."""

import copy
import time

from port_bench import common
from port_bench.drivers import Context

TINY_VAE = dict(enc_channels=16, dim_neck=4, dim_pre=16, dec_lstm2_hidden=16,
                postnet_channels=16, latent_dim=8, speaker_size=2)
TINY_VOC = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16, skip_out_channels=16)


def serve_ctx(cell: str = "serve-wavenet-c1", variant=None, seed: int = 2 ** 31 + 11,
              device: str = "cpu", clients: int = 2) -> Context:
    """The serving cell at a tiny width, with ``clients`` closed-loop
    clients (two by default: the load generator's threads and a drain of
    several requests are exercised even where the cell has one client)."""
    c = common.load_cell(cell)
    cfg = copy.deepcopy(c.config)
    cfg["vae"].update(TINY_VAE)
    cfg["vocoder"].update(TINY_VOC)
    tr = dict(c.traffic, clients=clients, set_size=2, requests_per_client=2,
              median_s=0.3, min_s=0.2, max_s=0.5, speakers=2, speaker_files=2,
              speaker_seconds=0.5)
    return Context(config=cfg, traffic=tr, settings=c.settings, seed=seed, seconds=0.5,
                   trace=False, device=device, t_start=time.perf_counter(), variant=variant)


def train_ctx(cell: str = "train-mel80-b256", variant=None, seed: int = 2 ** 31 + 7,
              device: str = "cpu") -> Context:
    c = common.load_cell(cell)
    cfg = copy.deepcopy(c.config)
    cfg["vae"].update(TINY_VAE, num_mels=8, frames=16)
    cfg["train"]["batch_size"] = 4
    tr = dict(c.traffic, speakers=3, files_per_speaker=6)
    return Context(config=cfg, traffic=tr, settings=c.settings, seed=seed, seconds=0.5,
                   trace=False, device=device, t_start=time.perf_counter(), variant=variant)
