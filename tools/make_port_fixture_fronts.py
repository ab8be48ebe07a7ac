"""Write the cardio MLP and SVM fronts that the PyTorch port's tests and
``chip_smoke.py`` serve (tests/fixtures/fronts/cardio_{mlp,svm}).

The JAX package searches and exports each front and saves it with
``repro.core.deploy.save_front``; ``extra_meta`` records the dataset and
the ``SearchConfig``. This is the only place that imports JAX for the
fixtures: the machine that runs ``chip_smoke.py`` has no JAX, so the
fronts are committed. About 20 s per front on a CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_port_fixture_fronts.py
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
from pathlib import Path

from repro.core import deploy, search
from repro.data import tabular

REPO = Path(__file__).resolve().parents[1]
DATASET = "cardio"


def make_front(kind: str, out: Path) -> None:
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)       # (21, 5, 3)
    cfg = search.SearchConfig(bits=4, pop_size=16, generations=3,
                              train_steps=100, model=kind)
    data = tabular.make_dataset(DATASET)
    pg, _, _, trained = search.run_search(data, sizes, cfg,
                                          return_trained=True)
    designs = deploy.export_front(pg, data, sizes, cfg, trained=trained)
    if out.exists():
        shutil.rmtree(out)
    deploy.save_front(out, designs, extra_meta={
        "dataset": DATASET, "sizes": list(sizes),
        "search_config": dataclasses.asdict(cfg)})
    accs = ", ".join(f"{d.accuracy:.4f}" for d in designs)
    print(f"{out}: {len(designs)} {kind} designs, accuracies [{accs}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=REPO / "tests" / "fixtures" / "fronts")
    args = ap.parse_args(argv)
    for kind in ("mlp", "svm"):
        make_front(kind, args.out / f"{DATASET}_{kind}")


if __name__ == "__main__":
    main()
