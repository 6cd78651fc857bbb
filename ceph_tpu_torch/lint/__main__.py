"""`python -m ceph_tpu_torch.lint` — see ceph_tpu_torch.lint.cli."""

import sys

from ceph_tpu_torch.lint.cli import main

sys.exit(main())
