"""``decode_attention``'s timing of ``chip_smoke.py``'s phase 11 alone, on
the card: the build, then the kernel beside its plain version and SDPA at
the serve shape, at ``decode_32k`` and with ``lo`` on mixtral-8x7b's
linear sliding-window cache, by CUDA events and by the profiler.  A
quick first look at a timing case before the whole script runs, on a
machine with a card::

    python3 tools/decode_timing_on_card.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("decode_timing_on_card: no CUDA device")
    dev = torch.device("cuda", 0)
    _, smi = cs.card()
    cs.build()
    timing = cs.time_decode_attention(dev)
    cs.profile_decode_attention(dev, timing)
    print(json.dumps({k: {kk: vv for kk, vv in timing[k].items()
                          if kk != "block"}
                      for k in ("decode_32k", "decode_32k_window")}))
    print(smi)
