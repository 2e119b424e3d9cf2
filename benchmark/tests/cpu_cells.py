"""Tiny CPU versions of the cells: the cell's own files with fewer rows
and clients, the snapshot smaller (the CLI flags appended, so the last
one given wins as on the command line)."""

import time

from benchmark import harness

SEED = 2**31 + 17


def tiny(cell: str, rows: int = 2000, clients: int = 2):
    w = harness.load("workloads", cell)
    cfg = harness.load("configs", w["config"])
    cfg = dict(cfg, rows=rows, n_clients=clients,
               flags=[*cfg["flags"], "--n-clients", str(clients)])
    traffic = harness.load("traffic", w["traffic"])
    traffic = dict(traffic, flags=[*traffic["flags"], "--sample-rows",
                                   str(min(rows, 2000))])
    return w, cfg, traffic


def run(cell: str, seed: int = SEED, trace: bool = False, rows: int = 2000,
        clients: int = 2) -> dict:
    w, cfg, traffic = tiny(cell, rows, clients)
    return harness.run_cell(cell, seed, 0.5, trace, time.perf_counter(),
                            device_name="cpu", workload=w, config=cfg,
                            traffic=traffic, log=lambda m: None)
