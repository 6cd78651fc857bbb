"""``python -m ceph_tpu_torch.rgw --id N --spec cluster_spec.json``

The rgw daemon main for vstart multi-process deployments (the
ceph-rgw binary's role): one daemon in its own OS process,
SIGTERM-clean, on the spec's device (`extras["device"]`, None = cuda,
which raises without a card). Pool bindings ride the spec's extras:
`rgw_data_pool` (default 2), `rgw_index_pool` (default 1, a replicated
pool: the bucket index is omap) and `rgw_users` (access key -> secret).
"""

import argparse

from ceph_tpu_torch.vstart import daemon_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args()
    daemon_main("rgw", args.id, args.spec)


main()
