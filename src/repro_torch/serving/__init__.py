from .engine import EngineStats, ModelRunner, RequestResult, ServingEngine
from .kv_chunks import (cache_to_chunks, chunks_from_store, layer_payload_to_kv,
                        prefix_kv_from_payloads)
from .orchestrator import Orchestrator, TransferPlan

__all__ = ["EngineStats", "ModelRunner", "Orchestrator", "RequestResult",
           "ServingEngine", "TransferPlan", "cache_to_chunks",
           "chunks_from_store", "layer_payload_to_kv",
           "prefix_kv_from_payloads"]
