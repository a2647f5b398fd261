"""One rank of a job that ``parallel.distributed.launch`` started:

    python -m elodin_tpu_torch.parallel MODULE:FUNCTION '{"kwarg": ...}'

joins the job (``init_multihost`` from the ``ELODIN_*`` variables the
launcher set), calls the function with the JSON keyword arguments and
prints its JSON result on a line of its own, after
``distributed.RESULT_PREFIX``."""

import json
import sys

import torch.distributed as dist

from elodin_tpu_torch.parallel import distributed


def main(argv) -> int:
    target, kwargs = argv[1], json.loads(argv[2]) if len(argv) > 2 else {}
    distributed.init_multihost()
    try:
        result = distributed.import_target(target)(**kwargs)
        print(distributed.RESULT_PREFIX + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
