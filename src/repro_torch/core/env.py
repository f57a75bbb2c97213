"""Device resolution and the platform fingerprint for the port.

The port runs on CUDA unless its caller asks for the CPU: no entry point
falls back to the CPU quietly.  :func:`fingerprint` names the card and
software a measurement was taken on.
"""
from __future__ import annotations

import platform as _platform
import shutil
import subprocess
from typing import Dict, Optional, Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means CUDA; a CUDA request without a CUDA device raises.
    ``"cpu"`` is honoured (the tests run the plain versions there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default -- pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _nvidia_smi(query: str) -> Optional[str]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    proc = subprocess.run([exe, f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        and proc.stdout.strip() else None


def platform_profile(device: Device = None) -> Dict[str, object]:
    """Machine, torch/CUDA versions and, on CUDA, the card's name,
    capability and power limit (from ``nvidia-smi``)."""
    prof: Dict[str, object] = {
        "system": _platform.system().lower(),
        "machine": _platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": "cpu",
    }
    dev = torch.device("cpu") if device is None and \
        not torch.cuda.is_available() else resolve_device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        prof.update(device=torch.cuda.get_device_name(dev),
                    capability=f"{major}.{minor}",
                    power_limit=_nvidia_smi("power.limit"))
    return prof


def fingerprint(device: Device = None) -> str:
    """Key naming the platform: ``{system}-{machine}-{device}-sm{cap}-
    torch{v}-cuda{v}-{power limit}``."""
    p = platform_profile(device)
    parts = [p["system"], p["machine"], str(p["device"]).replace(" ", "_")]
    if "capability" in p:
        parts.append(f"sm{str(p['capability']).replace('.', '')}")
    parts += [f"torch{p['torch']}", f"cuda{p['cuda']}"]
    if p.get("power_limit"):
        parts.append(str(p["power_limit"]).replace(" ", ""))
    return "-".join(parts)
