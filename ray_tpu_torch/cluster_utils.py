"""Multi-node test cluster on one machine (reference:
python/ray/cluster_utils.py:135 Cluster / add_node:202 / remove_node:286).

One GCS plus N raylets in the current process (each raylet still forks
real worker processes), which is how the reference tests multi-node
behaviour on localhost. A node's GPUs are ``add_node(num_gpus=...)``;
a ``num_gpus`` lease on it exports ``CUDA_VISIBLE_DEVICES`` as
``init(num_gpus=...)``'s node does. The JAX package's second shape,
the GCS and raylets as their own processes (``control_plane_procs=True``),
refuses until ROADMAP item 11b.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.common.status import not_ported
from ray_tpu_torch.gcs.server import GcsServer
from ray_tpu_torch.raylet.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 persist_dir: Optional[str] = None,
                 control_plane_procs: bool = False):
        if control_plane_procs:
            raise not_ported("control_plane")
        self.persist_dir = persist_dir
        self.raylets: List[Raylet] = []
        self.gcs = GcsServer(persist_dir=persist_dir)
        self.gcs.start()
        self._gcs_address = self.gcs.address
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def gcs_address(self):
        return self._gcs_address

    def kill_gcs(self):
        """Simulate a GCS crash: stop the server, leave raylets running."""
        self.gcs.server.stop()
        self.gcs._stopped = True
        if self.gcs.storage is not None:
            self.gcs.storage.close()
        self.gcs.kv.close()

    def restart_gcs(self):
        """Bring the GCS back at the SAME address, recovering state from the
        persist log; surviving raylets re-register via their report loop."""
        addr = self._gcs_address
        self.gcs = GcsServer(host=addr[0], port=addr[1],
                             persist_dir=self.persist_dir)
        self.gcs.start()

    @property
    def address(self) -> str:
        return f"{self._gcs_address[0]}:{self._gcs_address[1]}"

    def add_node(self, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> Raylet:
        node_resources = dict(resources or {})
        node_resources.setdefault("CPU", num_cpus)
        if num_gpus:
            node_resources["GPU"] = num_gpus
        raylet = Raylet(self._gcs_address, resources=node_resources,
                        labels=labels)
        raylet.start()
        self.raylets.append(raylet)
        return raylet

    def remove_node(self, raylet: Raylet, graceful: bool = False):
        """Kill a node (ungraceful = simulate crash: workers die, GCS finds
        out via health checks)."""
        raylet.stop()
        self.raylets.remove(raylet)
        if graceful:
            try:
                from ray_tpu_torch.gcs.client import GcsClient

                c = GcsClient(self._gcs_address)
                c.call("unregister_node", node_id=raylet.node_id.binary())
                c.close()
            except Exception:  # noqa: BLE001
                pass

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30.0) -> bool:
        from ray_tpu_torch.gcs.client import GcsClient

        want = count if count is not None else len(self.raylets)
        c = GcsClient(self._gcs_address)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                alive = [n for n in c.get_all_nodes() if n["alive"]]
                if len(alive) >= want:
                    return True
                time.sleep(0.1)
            return False
        finally:
            c.close()

    def shutdown(self):
        for r in list(self.raylets):
            r.stop()
        self.raylets.clear()
        self.gcs.stop()
