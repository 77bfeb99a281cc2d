"""The serving stack of the port: bucketing, the continuous-batching core,
the replicated dispatcher pool, and the sync and async LiNGAM engines over
the batched estimator on the card; and the LM engine (``engine.Engine``,
prefill + decode, the SSM family so far)."""

from repro_torch.serve.batching import (
    BatchingConfig,
    BatchingCore,
    BucketQuarantined,
    DispatchFailed,
    EngineClosed,
    ManualDispatcher,
    QueueFull,
    RequestTimeout,
    ServeError,
    Ticket,
    bucket_dim,
    bucket_dims,
    pad_to,
)
from repro_torch.serve.buckets import bucket_shape, pad_dataset
from repro_torch.serve.lingam_engine import (
    LingamEngine,
    LingamFit,
    LingamServeConfig,
    dispatch_bucket,
)
from repro_torch.serve.async_engine import AsyncLingamEngine, ServingPool
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.replica import (
    ChaosDispatcher,
    HungDispatch,
    ReplicaCrashed,
    ReplicaPool,
    ReplicaPoolConfig,
)
