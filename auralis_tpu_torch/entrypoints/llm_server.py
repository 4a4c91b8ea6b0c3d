"""Launch a sidecar OpenAI-compatible text-LLM server for the voice-chat
endpoint (capability parity with reference entrypoints/llm_server.py, which
hardcodes `vllm serve`). Here the serving command is configurable so any
OpenAI-compatible backend works (vllm, sglang, llama.cpp server, ...).

Usage:
    python -m auralis_tpu_torch.entrypoints.llm_server --cmd "vllm serve meta-llama/Llama-3.2-1B" \
        --host 127.0.0.1 --port 8001
"""
from __future__ import annotations

import argparse
import shlex
import subprocess
import sys


def start_llm_server(cmd: str, host: str, port: int) -> int:
    command = [*shlex.split(cmd), f"--host={host}", f"--port={port}"]
    print(f"launching sidecar LLM: {' '.join(command)}")
    try:
        return subprocess.run(command, check=True).returncode
    except FileNotFoundError:
        print(f"Error: command '{command[0]}' not found on PATH", file=sys.stderr)
        return 127
    except subprocess.CalledProcessError as e:
        print(f"Error starting LLM server: {e}", file=sys.stderr)
        return e.returncode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="sidecar OpenAI-compatible LLM launcher")
    ap.add_argument("--cmd", default="vllm serve meta-llama/Llama-3.2-1B",
                    help="base serve command to run")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    args = ap.parse_args(argv)
    raise SystemExit(start_llm_server(args.cmd, args.host, args.port))


if __name__ == "__main__":
    main()
