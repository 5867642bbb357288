"""Where the spread of chip_smoke.py's zoo f32 check comes from:
SimpleModel at its class defaults in f32, two runs on the card and the
CPU run at 1 and at all threads, each pair's max abs difference, and the
host CPU's model and flags. Needs a CUDA card; run from the repo root:

    python3 scripts/torch_zoo_spread.py
"""
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nerfmeshes_tpu_torch.models import nerf_models as tm  # noqa: E402
from nerfmeshes_tpu_torch.train.system import init_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(subprocess.run(["bash", "-c", "lscpu | grep -i 'model name\\|flags' | cut -c1-200"],
                     capture_output=True, text=True).stdout)
dev = torch.device("cuda")
pts, dirs = cs._zoo_points(dev)
cpu = tm.build_model("SimpleModel", {}, compute_dtype=torch.float32)
init_params(cpu, None, torch.Generator().manual_seed(cs.SEED))
card = tm.build_model("SimpleModel", {}, compute_dtype=torch.float32)
card.load_state_dict(cpu.state_dict())
card.to(dev)
outs = {}
for k in range(2):
    card.zero_grad(set_to_none=True)
    outs[f"card{k}"] = cs._zoo_step(card, pts, dirs)[0].cpu()
for threads in (1, torch.get_num_threads()):
    torch.set_num_threads(threads)
    cpu.zero_grad(set_to_none=True)
    outs[f"cpu{threads}"] = cs._zoo_step(cpu, pts.cpu(), dirs.cpu())[0]
names = list(outs)
for i, a in enumerate(names):
    for b in names[i + 1:]:
        print(f"{a} vs {b}: max abs diff {float((outs[a] - outs[b]).abs().max()):.3e}")
