"""Feature storage: host-DRAM store + device degree-ranked cache."""
from .cache import FeatureCache, FetchPlan, assemble_features_from_map, bucket_size
from .feature_store import FeatureStore
