"""``python -m ceph_tpu_torch.mon --id R --spec cluster_spec.json``

The monitor daemon main (the reference's ``src/ceph_mon.cc``): one Monitor
in its own OS process, FileDB-backed, SIGTERM for clean shutdown.
"""

import argparse

from ceph_tpu_torch.vstart import daemon_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True, help="mon rank")
    ap.add_argument("--spec", required=True, help="cluster spec path")
    args = ap.parse_args()
    daemon_main("mon", args.id, args.spec)


main()
