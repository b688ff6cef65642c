"""What the launchers give their child processes (free localhost ports
and an environment that imports this checkout's package), and the card
tools' refusal to run without a card."""
import os
import random
import socket

# The checkout holding the package.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child_env() -> dict:
    """This process's environment with the checkout first on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def free_ports(n: int) -> list:
    """n distinct free TCP ports below the kernel's ephemeral range. A
    port taken by bind(0) would be ephemeral, and any connection or
    bind(0) on the machine could take it between this choice and the
    child's own bind."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 32768
    out: list = []
    for _ in range(1000 * n):
        if len(out) == n:
            return out
        port = random.randrange(10000, lo)
        if port in out:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        out.append(port)
    if len(out) == n:
        return out
    raise RuntimeError("no free port below the ephemeral range")


def require_device(device: str, how: str) -> None:
    """Exit 1 with a message when `device` is the card and there is no
    card: a card tool goes on on the CPU only when asked to (`how` says
    how to ask)."""
    import sys

    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"device {device} but no CUDA device is available; {how} to "
              "run on the CPU", file=sys.stderr)
        sys.exit(1)
