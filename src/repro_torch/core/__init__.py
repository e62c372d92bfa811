# The paper's primary contribution: ObjectCache — layerwise object-storage
# retrieval for KV cache reuse (protocol + scheduling co-design).
from .aggregation import (DEFAULT_THETA_BYTES, AggResult, StorageServer,
                          select_mode)
from .compute_model import A100_LLAMA31_8B, MeasuredCompute, PaperComputeModel
from .descriptor import (Descriptor, RdmaTarget, descriptor_overhead_bytes,
                         make_descriptor)
from .gateway import Gateway, S3Path
from .hashing import GENESIS, chunk_keys, extend_keys
from .layout import (layer_range, pack_chunk, unpack_chunk,
                     unpack_layer_payload, wire_dtype)
from .object_store import FileStore, InMemoryStore, ObjectStore, TieredStore
from .overlap import (chunkwise_ttft, gated_layerwise_schedule,
                      gated_layerwise_ttft, layerwise_ttft, per_layer_stalls,
                      pipeline_ttft, required_bandwidth, steady_pipeline_ttft)
from .radix import RadixIndex
from .scheduler import (BandwidthPool, Policy, added_ttft, allocate,
                        per_layer_stall, total_transfer_time)
from .simulator import (PAPER_MARGIN_BPS, WORKLOAD_A, WORKLOAD_B, WORKLOAD_C,
                        ServingSimulator, TTFTResult, WorkloadRequest)
from .transport import (LOCAL_DRAM, PROFILES, S3_RDMA_AGG, S3_RDMA_BATCH,
                        S3_RDMA_BUFFER, S3_RDMA_DIRECT, S3_TCP, VirtualClock,
                        WallClock)
from .types import (CODEC_GW4, CODEC_GW8, CODEC_IDENTITY, CODEC_INT4,
                    CODEC_INT8, CODEC_MIXED, CODEC_NAMES, CODEC_WIRE_IDS,
                    CodecFormat, Delivery, FlowRequest, KVSpec, LayerReady,
                    MatchResult, Timing, codec_wire_id, parse_codec)

__all__ = [k for k in dir() if not k.startswith("_")]
