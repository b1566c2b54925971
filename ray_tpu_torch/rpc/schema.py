"""Typed wire schemas for core RPC methods.

Reference: ``src/ray/protobuf/*.proto`` — the reference's wire contract is
compiled IDL; ours is framed pickle envelopes, which round 2 shipped with
an *implicit* contract (SURVEY §1 row 0). This module makes the contract
explicit and machine-checked: each core method declares a
:class:`Message` of typed fields, the server validates inbound requests
against it (strict-by-default via ``rpc_schema_validation``), and the
table doubles as the protocol's documentation and versioning anchor.

Design notes vs protobuf:
- Values still travel as framed pickle (zero-copy buffer support,
  ``serialization.py``); the schema governs STRUCTURE, not encoding —
  the same split the reference has between protoc codegen and gRPC bytes.
- Unknown fields are allowed by default (wire compatibility for rolling
  upgrades: new clients may send fields old servers ignore), required
  fields and type mismatches are errors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type, Union

SCHEMA_VERSION = 1


class SchemaError(TypeError):
    pass


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    # a type, tuple of types, or None for "any pickled value"
    type: Union[Type, Tuple[Type, ...], None]
    required: bool = True
    # protocol version (rpc/protocol.py) that introduced the field: a
    # required field is only ENFORCED against peers new enough to know it
    # — the rolling-upgrade contract protobuf gets from field numbers
    since: int = 1

    def check(self, method: str, kwargs: Dict[str, Any],
              peer_protocol: int = 1_000_000) -> None:
        if self.name not in kwargs:
            if self.required and peer_protocol >= self.since:
                raise SchemaError(
                    f"{method}: missing required field {self.name!r}")
            return
        if self.type is None:
            return
        v = kwargs[self.name]
        if v is None and not self.required:
            return  # optional fields are nullable
        if not isinstance(v, self.type):
            raise SchemaError(
                f"{method}: field {self.name!r} expects "
                f"{self.type}, got {type(v).__name__}")


@dataclasses.dataclass(frozen=True)
class Message:
    name: str
    fields: Tuple[Field, ...]
    allow_unknown: bool = True

    def validate(self, kwargs: Dict[str, Any],
                 peer_protocol: int = 1_000_000) -> Dict[str, Any]:
        """Check and return the kwargs to dispatch. Unknown fields are
        STRIPPED (not just tolerated) when allowed: handlers don't take
        **kwargs, so passing a newer client's extra fields through would
        crash the handler and void the rolling-upgrade guarantee.
        ``peer_protocol`` relaxes required fields newer than the peer
        (``Field.since``)."""
        for f in self.fields:
            f.check(self.name, kwargs, peer_protocol)
        known = {f.name for f in self.fields}
        unknown = set(kwargs) - known
        if not unknown:
            return kwargs
        if not self.allow_unknown:
            raise SchemaError(
                f"{self.name}: unknown fields {sorted(unknown)}")
        return {k: v for k, v in kwargs.items() if k in known}


def _m(name: str, *fields: Field) -> Message:
    return Message(name, tuple(fields))


def req(name: str, type_=None) -> Field:
    return Field(name, type_, required=True)


def opt(name: str, type_=None) -> Field:
    return Field(name, type_, required=False)


_num = (int, float)

# The wire contract of the core services. One entry per RPC method;
# handlers without an entry skip validation (library-level RPCs whose
# payloads are full pickled objects).
RPC_SCHEMAS: Dict[str, Message] = {
    # ---- worker service (reference core_worker.proto) ----
    "push_task": _m("push_task", req("spec", bytes)),
    "cancel_task": _m("cancel_task", opt("object_id", bytes),
                      opt("task_id", bytes), opt("force", bool)),
    "cancel_running_task": _m("cancel_running_task", req("task_id", bytes),
                              opt("force", bool)),
    "create_actor": _m("create_actor", req("creation_spec", bytes),
                       req("node_id", bytes),
                       # coalesced device grant: GPUs ride the creation
                       # push instead of a separate set_visible_devices
                       # round trip (raylet h_start_actor)
                       opt("gpu_ids", (tuple, list))),
    "get_object": _m("get_object", req("object_id", bytes),
                     opt("timeout", _num)),
    "object_info": _m("object_info", req("object_id", bytes),
                      opt("timeout", _num)),
    "get_object_chunk": _m("get_object_chunk", req("object_id", bytes),
                           req("offset", int), req("length", int)),
    "free_object": _m("free_object", req("object_id", bytes),
                      opt("borrowed", bool), opt("worker_id", bytes)),
    "reconstruct_object": _m("reconstruct_object", req("object_id", bytes)),
    "report_generator_item": _m(
        "report_generator_item", req("task_id", bytes), opt("index", int),
        opt("done", bool), opt("total", int), opt("value", bytes),
        opt("error", bytes), opt("location", (tuple, list))),
    "incref_inflight": _m("incref_inflight", req("object_id", bytes),
                          opt("worker_id", bytes), opt("token", bytes)),
    "borrow_ack": _m("borrow_ack", req("object_id", bytes),
                     opt("worker_id", bytes), opt("token", bytes)),
    "borrow_release": _m("borrow_release", req("object_id", bytes),
                         opt("worker_id", bytes), opt("token", bytes)),
    # ---- raylet service (reference node_manager.proto) ----
    # NOTE: declare only fields the handler accepts — unknown inbound
    # fields are stripped pre-dispatch, so a field listed here but absent
    # from the handler would pass through and crash it.
    "request_worker_lease": _m(
        "request_worker_lease", req("lease_id", bytes),
        req("resources", dict), opt("strategy", bytes),
        opt("pg", (tuple, list)), opt("runtime_env", dict),
        opt("grant_only_local", bool), opt("job_id", bytes),
        # argument-locality hint: {node_id_hex: total_arg_bytes} from the
        # submitter's owner-side location cache (scheduling/policies.py)
        opt("locality", dict)),
    "return_worker": _m("return_worker", req("lease_id", bytes),
                        opt("disconnect", bool)),
    "register_worker": _m("register_worker", req("worker_id", bytes),
                          req("address", (tuple, list)),
                          opt("fast_port", int)),
    "configure_worker": _m("configure_worker", opt("env_vars", dict),
                           opt("cwd", str)),
    "start_actor": _m("start_actor", req("creation_spec", bytes)),
    "kill_worker": _m("kill_worker", req("worker_id", bytes)),
    "worker_alive": _m("worker_alive", req("worker_id", bytes)),
    # ---- GCS service (reference gcs_service.proto) ----
    "register_node": _m("register_node", req("node_id", bytes),
                        req("address", (tuple, list)),
                        req("resources", dict), req("labels", dict),
                        opt("object_store_address", str),
                        # node transfer-service endpoint [host, port]
                        # (object_store/transfer.py)
                        opt("transfer_address", (tuple, list)),
                        opt("live_actors", list), opt("held_bundles", list)),
    "register_actor": _m("register_actor", req("creation_spec", bytes),
                         req("actor_id", bytes), req("job_id", bytes),
                         opt("name", str), opt("namespace", str),
                         opt("max_restarts", int)),
    # coalesced unnamed-actor registration (one RPC per driver-side burst)
    "register_actors": _m("register_actors", req("specs", list),
                          req("job_id", bytes)),
    "report_resources": _m("report_resources", req("node_id", bytes),
                           req("snapshot", dict), req("seq", int),
                           opt("stats", dict)),
    "report_actor_state": _m("report_actor_state", req("actor_id", bytes),
                             req("state", str), opt("worker_id", bytes),
                             opt("address", (tuple, list)),
                             opt("node_id", bytes), opt("death_cause", str),
                             opt("fast_port", int)),
    # object location directory (reference gcs_service.proto
    # ObjectLocationInfo): owner-coalesced batches of add/remove/spill
    # transitions, and bulk resolution for cold fetches
    "object_locations_update": _m("object_locations_update",
                                  req("updates", list)),
    "get_object_locations": _m("get_object_locations",
                               req("object_ids", list)),
    "kv_put": _m("kv_put", req("namespace", str), req("key", (bytes, str)),
                 req("value", bytes), opt("overwrite", bool)),
    "kv_get": _m("kv_get", req("namespace", str), req("key", (bytes, str))),
    "kv_del": _m("kv_del", req("namespace", str), req("key", (bytes, str))),
    "publish_worker_log": _m("publish_worker_log", req("job_id", str),
                             req("pid", int), req("worker_id", str),
                             req("stream", str), req("lines", list),
                             opt("actor_name", str)),
}


def validate(method: str, kwargs: Dict[str, Any],
             peer_protocol: int = 1_000_000) -> Dict[str, Any]:
    """Check a request against the wire contract and return the kwargs to
    dispatch (unknown fields stripped); pass-through for methods without
    a declared schema. ``peer_protocol`` is the connection-negotiated
    version of the requesting peer (rpc/protocol.py)."""
    schema = RPC_SCHEMAS.get(method)
    if schema is None:
        return kwargs
    return schema.validate(kwargs, peer_protocol)
