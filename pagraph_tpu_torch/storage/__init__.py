"""Feature storage: host-DRAM store + device degree-ranked cache."""
from .cache import FeatureCache, FetchPlan, assemble_features, bucket_size
from .feature_store import FeatureStore
