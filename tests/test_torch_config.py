"""The port's config copy equals the reference's, and the port imports no jax."""

import dataclasses
import os
import subprocess
import sys

import pytest

import _torch_parity as P  # noqa: F401  (caps torch threads)
from aslam_tpu import config as ref
from aslam_tpu_torch import config as port

CLASSES = ["CameraModel", "ExtractorConfig", "MatcherConfig", "RansacConfig",
           "ICPConfig", "BAConfig", "TrackingConfig", "MapConfig",
           "LoopConfig", "MeshConfig", "SystemConfig"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the SLAM slices (config 2, then config 3 and loop closing): each must
# import without jax or aslam_tpu
SLAM_MODULES = [f"aslam_tpu_torch.{m}" for m in (
    "ops.index", "ops.lba", "ops.pose_graph", "models.mapstate",
    "models.tracking", "models.localmapping", "models.device_slam",
    "ops.icp", "ops.bow", "ops.global_ba", "models.loopclosing",
    "utils.synthetic_hard",
    # the host shell: CLI, host engine, checkpoints, loader
    "main", "models.system", "utils.checkpoint", "utils.dataset",
    "utils.metrics", "utils.pointcloud", "native.loader", "native.build",
    # batched VO, the viewers, the CPU baseline
    "models.batch_vo", "utils.viewer", "utils.webviewer", "baselines.refcpu",
    # distributed BA over torch.distributed
    "parallel", "parallel.mesh", "parallel.launch", "parallel.sharded_ba",
    "parallel.sharded_global_ba", "parallel.sharded_gn_cg",
    "parallel.partition", "parallel.dryrun")]


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if default is not dataclasses.MISSING and dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        out.append((f.name, f.type, default, f.default_factory))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_matches_reference(name):
    r, p = getattr(ref, name), getattr(port, name)
    assert _fields(p) == _fields(r)
    assert p.__dataclass_params__.frozen and r.__dataclass_params__.frozen


def test_presets_and_small_config_match_reference():
    for preset in ("TUM_FR1", "TUM_FR2", "TUM_FR3", "ICL_NUIM"):
        assert (dataclasses.asdict(getattr(port, preset))
                == dataclasses.asdict(getattr(ref, preset)))
    assert (dataclasses.asdict(port.small_config())
            == dataclasses.asdict(ref.small_config()))
    for r, p in ((ref.SystemConfig(), port.SystemConfig()),
                 (ref.small_config(), port.small_config())):
        assert p.extractor.features_per_level == r.extractor.features_per_level
        assert p.extractor.scale_factors == r.extractor.scale_factors
        assert p.camera.th_depth == r.camera.th_depth
        assert p.camera.has_distortion == r.camera.has_distortion
    # the reference's config, carried across, is the port's
    assert P.port_config(ref.small_config()) == port.small_config()
    assert P.port_config(ref.SystemConfig()) == port.SystemConfig()


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import aslam_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "aslam_tpu_torch.__path__, 'aslam_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"missing = set({SLAM_MODULES!r}) - set(mods)\n"
        "assert not missing, missing\n"
        "import chip_smoke\n"
        "import os\n"
        "from aslam_tpu_torch.config import SystemConfig\n"
        "from aslam_tpu_torch.models.loopclosing import _default_vocab_path\n"
        "from aslam_tpu_torch.ops.bow import load_vocabulary\n"
        "path = _default_vocab_path(SystemConfig())\n"
        "pkg = os.path.dirname(os.path.abspath(aslam_tpu_torch.__file__))\n"
        "assert path == os.path.join(pkg, 'assets', 'vocab_10_4.npz'), path\n"
        "assert load_vocabulary(path).n_words == 10**4\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'aslam_tpu' not in sys.modules, 'aslam_tpu imported'\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 32
