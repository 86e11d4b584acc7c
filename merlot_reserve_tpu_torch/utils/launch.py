"""Launching a training job of one process per card with ``torchrun``.

The counterpart of ``merlot_reserve_tpu/utils/tpu_run.py``, which creates a
TPU VM pod through gcloud, pushes the code and starts
``scripts/pretrain.py -distributed`` on every worker. GPU machines are
reached however a site reaches them (a scheduler, ssh); what the port
needs is the command each node runs: ``torchrun`` with the node's process
count, the number of nodes, the node's rank and a rendezvous endpoint,
then ``scripts/pretrain_torch.py <config> -distributed`` with the output
directory. ``TorchrunLauncher`` builds those commands, and runs them on
this machine when asked; nothing here creates a machine or downloads
anything.

``dry_run=True`` records the commands (``issued_commands``) and starts
nothing, as ``TPUCreator(dry_run=True)`` does.

    launcher = TorchrunLauncher(nproc_per_node=8, nnodes=2,
                                rdzv_endpoint="node0:29500", dry_run=True)
    launcher.launch_training("configs/base.yaml", output_dir="out", node_rank=0)
"""

from __future__ import annotations

import shlex
import subprocess
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class TorchrunLauncher:
    """torchrun command lines for a job of ``nnodes`` nodes of
    ``nproc_per_node`` processes (one per card) each.

    :param rdzv_endpoint: host:port of the rendezvous (c10d backend); on
        one node the default ``localhost:29500``
    :param rdzv_id: the job's rendezvous id
    :param python: the interpreter to run torchrun under
    """

    nproc_per_node: int = 1
    nnodes: int = 1
    rdzv_endpoint: str = "localhost:29500"
    rdzv_id: str = "merlot_reserve"
    python: str = sys.executable
    dry_run: bool = False
    _log: List[str] = field(default_factory=list)

    def torchrun_command(self, script: str, args: Sequence[str] = (),
                         node_rank: Optional[int] = None) -> List[str]:
        """``python -m torch.distributed.run`` (torchrun) for ``script``: one
        node's command. On one node it is a standalone rendezvous; on
        several, ``node_rank`` names the node (it is also inferred by the
        c10d rendezvous when None)."""
        cmd = [self.python, "-m", "torch.distributed.run",
               f"--nproc_per_node={self.nproc_per_node}", f"--nnodes={self.nnodes}"]
        if self.nnodes == 1:
            cmd.append("--standalone")
        else:
            cmd += ["--rdzv_backend=c10d", f"--rdzv_endpoint={self.rdzv_endpoint}",
                    f"--rdzv_id={self.rdzv_id}"]
            if node_rank is not None:
                cmd.append(f"--node_rank={node_rank}")
        return cmd + [script, *args]

    def pretrain_command(self, config: str = "configs/base.yaml",
                         output_dir: Optional[str] = None, extra_args: Sequence[str] = (),
                         node_rank: Optional[int] = None,
                         script: str = "scripts/pretrain_torch.py") -> List[str]:
        """The pretraining command of one node: ``scripts/pretrain_torch.py
        <config> -distributed`` under torchrun."""
        args = [config, "-distributed"]
        if output_dir:
            args += ["-output_dir", output_dir]
        return self.torchrun_command(script, args + list(extra_args), node_rank)

    def _run(self, cmd: List[str], cwd: Optional[str] = None) -> int:
        self._log.append(" ".join(shlex.quote(c) for c in cmd))
        if self.dry_run:
            print(f"[dry-run] {self._log[-1]}")
            return 0
        return subprocess.run(cmd, cwd=cwd).returncode

    def launch_training(self, config: str = "configs/base.yaml",
                        output_dir: Optional[str] = None, extra_args: Sequence[str] = (),
                        node_rank: Optional[int] = None, cwd: Optional[str] = None) -> int:
        """Run this node's pretraining command here (and wait for it);
        returns its exit code (0 in a dry run)."""
        return self._run(self.pretrain_command(config, output_dir, extra_args, node_rank),
                         cwd=cwd)

    def node_commands(self, config: str = "configs/base.yaml",
                      output_dir: Optional[str] = None,
                      extra_args: Sequence[str] = ()) -> List[str]:
        """Every node's command line, node 0 first: what a scheduler or an
        ssh loop starts on each."""
        return [" ".join(shlex.quote(c) for c in
                         self.pretrain_command(config, output_dir, extra_args, rank))
                for rank in range(self.nnodes)]

    @property
    def issued_commands(self) -> List[str]:
        return list(self._log)
