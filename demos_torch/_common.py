"""What the port's demos share: their command line, their output
directory, and the check that the port ran without JAX."""
import argparse
import os
import sys

# figures and records go under the repo's chiprun_out/ (gitignored), never
# docs/, whose files predate the port
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")


def parse_args(description, ranks=False):
    """``--device`` (default: the card; ``cpu`` to run on the CPU),
    ``--small``, ``--no-plot`` and, with ``ranks``, ``--ranks N``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, which must be present); 'cpu'")
    p.add_argument("--small", action="store_true", help="a quick, coarse run")
    p.add_argument("--no-plot", dest="plot", action="store_false", help="write no figures")
    if ranks:
        p.add_argument("--ranks", type=int, default=0,
                       help="run every form cell-sharded over N torch.distributed ranks "
                            "(gloo; one process each)")
    return p.parse_args()


def out_dir(kind):
    path = os.path.join(OUT_DIR, kind)
    os.makedirs(path, exist_ok=True)
    return path


def check_no_jax():
    """The port never imports JAX: fail the demo if it did."""
    assert "jax" not in sys.modules, "the PyTorch port imported jax"
