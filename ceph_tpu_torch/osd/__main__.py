"""``python -m ceph_tpu_torch.osd --id N --spec cluster_spec.json``

The OSD daemon main (the reference's ``src/ceph_osd.cc:106``): one
OSDService in its own OS process, FileDB-backed, SIGTERM for clean
shutdown; SIGKILL is the crash path the multi-process thrasher exercises.
"""

import argparse

from ceph_tpu_torch.vstart import daemon_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True, help="osd id")
    ap.add_argument("--spec", required=True, help="cluster spec path")
    args = ap.parse_args()
    daemon_main("osd", args.id, args.spec)


main()
