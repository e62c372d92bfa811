from .engine import EngineStats, ModelRunner, RequestResult, ServingEngine
from .kv_chunks import (PackedLayerKV, cache_to_chunks, chunks_from_store,
                        layer_payload_to_kv, layer_payload_to_packed_kv,
                        packed_layer_to_fp, prefix_kv_from_payloads)
from .orchestrator import Orchestrator, TransferPlan

__all__ = ["EngineStats", "ModelRunner", "Orchestrator", "PackedLayerKV",
           "RequestResult", "ServingEngine", "TransferPlan", "cache_to_chunks",
           "chunks_from_store", "layer_payload_to_kv",
           "layer_payload_to_packed_kv", "packed_layer_to_fp",
           "prefix_kv_from_payloads"]
