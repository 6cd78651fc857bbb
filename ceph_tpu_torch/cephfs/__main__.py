"""``python -m ceph_tpu_torch.cephfs --id N --spec cluster_spec.json``

The mds daemon main for vstart multi-process deployments (the
ceph-mds binary's role): one daemon in its own OS process,
SIGTERM-clean, on the spec's device (`extras["device"]`, None = cuda);
the metadata pool is `extras["mds_data_pool"]`.
"""

import argparse

from ceph_tpu_torch.vstart import daemon_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args()
    daemon_main("mds", args.id, args.spec)


main()
