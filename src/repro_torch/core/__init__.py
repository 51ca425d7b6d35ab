# Merlin's contribution, ported to PyTorch: hierarchical task generation,
# producer-consumer brokers (in-memory and shared-directory), parameter x
# sample DAG layering, device-fused ensemble execution (one CUDA graph a
# bucket), bundling/aggregation, and crawl-resubmit resilience.  The
# networked, sharded and elastic brokers and the chaos harness of the
# reference come with a later slice.
from repro_torch.core.queue import (Broker, BrokerError, BrokerFull,  # noqa
                                    BrokerUnavailable, StaleEpochError,
                                    InMemoryBroker, FileBroker, Task,
                                    new_task, PRIORITY_REAL, PRIORITY_GEN,
                                    dlq_queue_name, is_dlq, original_queue)
from repro_torch.core.hierarchy import HierarchyCfg, root_task, expand  # noqa
from repro_torch.core.spec import StudySpec, Step, SpecError  # noqa
from repro_torch.core.dag import TaskDag, DagNode, DagEdge, compile_dag  # noqa
from repro_torch.core.handlers import (ExecutionHandler,  # noqa
                                       FnStepHandler, SubprocessHandler,
                                       SchedulerJobHandler, MockScheduler,
                                       HandlerError)
from repro_torch.core.runtime import MerlinRuntime  # noqa
from repro_torch.core.worker import Worker, WorkerPool  # noqa
from repro_torch.core.bundler import Bundler, missing_samples  # noqa
from repro_torch.core.ensemble import EnsembleExecutor  # noqa
from repro_torch.core.resilience import (RetryPolicy, BackoffPolicy,  # noqa
                                         CircuitBreaker)
