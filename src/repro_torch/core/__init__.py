# Merlin's contribution, ported to PyTorch: hierarchical task generation,
# producer-consumer brokers (in-memory, shared-directory, and networked),
# parameter x sample DAG layering, device-fused ensemble execution (one
# CUDA graph a bucket), bundling/aggregation, and crawl-resubmit resilience.
from repro_torch.core.queue import (Broker, BrokerError, BrokerFull,  # noqa
                              BrokerUnavailable, StaleEpochError,
                              InMemoryBroker, FileBroker, Task, new_task,
                              PRIORITY_REAL, PRIORITY_GEN,
                              dlq_queue_name, is_dlq, original_queue)
from repro_torch.core.netbroker import BrokerServer, NetBroker, make_broker  # noqa
from repro_torch.core.shardbroker import (ShardedBroker,  # noqa
                                    migrate_queue_between,
                                    join_federation, leave_federation)
from repro_torch.core.hashring import (HashRing, Membership,  # noqa
                                 read_membership, join_membership,
                                 leave_membership, heartbeat_membership,
                                 sweep_membership, pin_queue)
from repro_torch.core.autoscale import Autoscaler, AutoscalePolicy  # noqa
from repro_torch.core.hierarchy import HierarchyCfg, root_task, expand  # noqa
from repro_torch.core.spec import StudySpec, Step, SpecError  # noqa
from repro_torch.core.dag import TaskDag, DagNode, DagEdge, compile_dag  # noqa
from repro_torch.core.handlers import (ExecutionHandler, FnStepHandler,  # noqa
                                 SubprocessHandler, SchedulerJobHandler,
                                 MockScheduler, HandlerError)
from repro_torch.core.runtime import MerlinRuntime  # noqa
from repro_torch.core.worker import Worker, WorkerPool  # noqa
from repro_torch.core.bundler import Bundler, missing_samples  # noqa
from repro_torch.core.ensemble import EnsembleExecutor  # noqa
from repro_torch.core.resilience import (RetryPolicy, BackoffPolicy,  # noqa
                                   CircuitBreaker)
from repro_torch.core.chaos import ChaosBroker, FlakyFn  # noqa
