"""A configuration, a traffic mix, a limits file and a per-layer metric
added under new names, as files beside the existing ones plus entries in the
benchmark's description, run without an edit to any existing file."""

import json
import os
import shutil

from gpubench import run

import tiny

READER = '''
def read(record):
    occ = record.get("slot_occupancy")
    return None if not occ else float(len(occ))
'''


def test_new_config_mix_and_metric_as_files(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(tiny.DATA, root)
    shutil.copytree(os.path.join(run.HERE, "metrics"), root / "metrics")
    with open(root / "configs" / "tiny-v3.json") as f:
        spec = json.load(f)
    spec["name"], spec["num_hidden_layers"] = "tiny-v3-1l", 1
    (root / "configs" / "tiny-v3-1l.json").write_text(json.dumps(spec))
    with open(root / "traffic" / "tiny-serve.json") as f:
        mix = json.load(f)
    mix["slots"] = mix["clients"] = 2
    (root / "traffic" / "tiny-serve-2.json").write_text(json.dumps(mix))
    (root / "limits" / "tiny-v3-1l.serve2.json").write_text(json.dumps({"lp_err_p50": 1e-3}))
    (root / "metrics" / "steps_seen.serve2.py").write_text(READER)
    b = tiny.bench()
    b["workloads"].append({"name": "tiny-v3-1l.serve2", "config": "tiny-v3-1l",
                           "traffic": "tiny-serve-2", "chips": 1})
    for m in b["end_to_end"]:
        if "workloads" in m and "tiny-v3.serve" in m["workloads"]:
            m["workloads"].append("tiny-v3-1l.serve2")
    b["per_layer"].append({"name": "steps_seen.serve2", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "Serving",
                           "moves": "out_tok_s", "workloads": ["tiny-v3-1l.serve2"]})
    res = run.run_cell(b, "tiny-v3-1l.serve2", 3, 0.5, True, "cpu", root=str(root),
                       log=lambda s: None)
    assert res["correct"], res["check"]
    assert res["metrics"]["steps_seen.serve2"]["value"] >= 1
