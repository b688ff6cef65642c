from etcd_tpu_torch.migrate.etcd4 import (decode_config4, decode_log4,
                                    decode_latest_snapshot4, migrate_4_to_2)
from etcd_tpu_torch.migrate.standby import (StandbyInfo, decode_standby_info,
                                      standby_to_proxy)

__all__ = ["decode_config4", "decode_log4", "decode_latest_snapshot4",
           "migrate_4_to_2", "StandbyInfo", "decode_standby_info",
           "standby_to_proxy"]
