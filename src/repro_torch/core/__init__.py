# UMap core: user-space page management (the paper's primary contribution).
#
#   config     UMapConfig + UMAP_* env parity (§4.2)
#   store      extensible backing stores (§3.4)
#   pagetable  page metadata / life-cycle
#   buffer     fixed slot pool + eviction policies (§3.1, §3.6)
#   pager      fault queue, filler/evictor pools, load balancing (§3.2–3.3)
#   watermark  dirty-page high/low-watermark flushing (§3.5)
#   region     umap()/uunmap() mmap-like API (§4.1)
#   resilient  retries / circuit breakers / checksums + chaos harness (DESIGN.md §17)
#   hints      access advisors, prefetch planning, page-size advisor (§3.6)
#   pattern    online access-pattern classifier — adaptive engine (DESIGN.md §8)

from .buffer import (  # noqa: F401
    ClockPolicy,
    EvictionPolicy,
    FifoPolicy,
    LruPolicy,
    PageBuffer,
    SlidingWindowPolicy,
    make_policy,
)
from .config import UMapConfig, parse_size  # noqa: F401
from .hints import (  # noqa: F401
    AccessAdvice,
    PageSizeAdvisor,
    StoreProfile,
    TierHint,
    WorkloadProfile,
    advice_for_phase,
    apply_advice,
    phase_for_advice,
    plan_prefetch,
)
from .lease import LeaseRun, PageLease  # noqa: F401
from .pagetable import (  # noqa: F401
    PageEntry,
    PageState,
    PageTable,
    ShardedPageTableView,
)
from .pattern import (  # noqa: F401
    AccessPatternClassifier,
    Phase,
    PhaseDecision,
    PHASE_SETTINGS,
)
from .pager import PagingService, ServiceStats  # noqa: F401
from .region import UMapArrayView, UMapRegion, umap, uunmap  # noqa: F401
from .resilient import (  # noqa: F401
    BreakerOpenError,
    ChaosStore,
    CircuitBreaker,
    CorruptPageError,
    ResilientStore,
    RetryPolicy,
)
from .store import (  # noqa: F401
    BackingStore,
    FaultyStore,
    FileStore,
    HostArrayStore,
    MultiFileStore,
    RemoteStore,
    SyntheticStore,
    TierChain,
    TieredStore,
    build_tier_stores,
    parse_tier_chain,
)
from .watermark import WatermarkMonitor  # noqa: F401
