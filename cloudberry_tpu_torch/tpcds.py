"""TPC-DS data and queries for the port: a copy of the JAX package's
tools/tpcdsgen.py (tpcds-lite: ``SCHEMAS``, ``DIST_KEYS``, ``generate``,
``load_tpcds``) and of the 30 query texts of tools/tpcds_queries.py, so
that a run on the card needs nothing of the JAX package.

tpcds-lite generates the tables the query subset touches, with simplified
value distributions; what matters is the join topology — store_sales ⋈
store_returns on the composite (customer, item, ticket) key, a
many-to-many catalog_sales join, three date_dim roles. Correctness checks
compare against another engine over the SAME generated data. At scale 100
the fact tables have 3,000,000 store_sales, 2,000,000 catalog_sales,
1,500,000 web_sales and 2,500,000 inventory rows (TPC-DS SF1's
store_sales has 2,880,404); date_dim always covers four years (1,460 rows)
and item has 500 rows per unit of scale."""

from __future__ import annotations

import numpy as np

from cloudberry_tpu_torch import types as T
from cloudberry_tpu_torch.types import Schema, date_to_days

SCHEMAS: dict[str, Schema] = {
    "date_dim": Schema.of(d_date_sk=T.INT64, d_date=T.DATE, d_year=T.INT32,
                          d_moy=T.INT32, d_quarter_name=T.STRING,
                          d_week_seq=T.INT32, d_day_name=T.STRING),
    "item": Schema.of(i_item_sk=T.INT64, i_item_id=T.STRING,
                      i_item_desc=T.STRING, i_current_price=T.DECIMAL(2),
                      i_brand_id=T.INT32, i_brand=T.STRING,
                      i_class=T.STRING, i_category=T.STRING,
                      i_manufact_id=T.INT32, i_manager_id=T.INT32),
    "store": Schema.of(s_store_sk=T.INT64, s_store_id=T.STRING,
                       s_store_name=T.STRING, s_state=T.STRING),
    "customer": Schema.of(c_customer_sk=T.INT64, c_customer_id=T.STRING,
                          c_first_name=T.STRING, c_last_name=T.STRING,
                          c_current_addr_sk=T.INT64),
    "customer_address": Schema.of(ca_address_sk=T.INT64,
                                  ca_state=T.STRING, ca_zip=T.STRING),
    "time_dim": Schema.of(t_time_sk=T.INT64, t_hour=T.INT32),
    "web_page": Schema.of(wp_web_page_sk=T.INT64,
                          wp_char_count=T.INT32),
    "catalog_returns": Schema.of(cr_order_number=T.INT64,
                                 cr_return_amount=T.DECIMAL(2)),
    "web_returns": Schema.of(wr_order_number=T.INT64,
                             wr_return_amt=T.DECIMAL(2)),
    "store_sales": Schema.of(ss_sold_date_sk=T.INT64, ss_item_sk=T.INT64,
                             ss_customer_sk=T.INT64, ss_ticket_number=T.INT64,
                             ss_store_sk=T.INT64, ss_quantity=T.INT32,
                             ss_ext_sales_price=T.DECIMAL(2),
                             ss_net_profit=T.DECIMAL(2)),
    "store_returns": Schema.of(sr_returned_date_sk=T.INT64,
                               sr_item_sk=T.INT64, sr_customer_sk=T.INT64,
                               sr_ticket_number=T.INT64,
                               sr_return_quantity=T.INT32,
                               sr_net_loss=T.DECIMAL(2)),
    "catalog_sales": Schema.of(cs_sold_date_sk=T.INT64, cs_item_sk=T.INT64,
                               cs_bill_customer_sk=T.INT64,
                               cs_quantity=T.INT32,
                               cs_net_profit=T.DECIMAL(2),
                               cs_ext_sales_price=T.DECIMAL(2),
                               cs_order_number=T.INT64,
                               cs_warehouse_sk=T.INT64,
                               cs_ship_date_sk=T.INT64,
                               cs_ext_ship_cost=T.DECIMAL(2)),
    "web_sales": Schema.of(ws_sold_date_sk=T.INT64, ws_item_sk=T.INT64,
                           ws_bill_customer_sk=T.INT64,
                           ws_quantity=T.INT32,
                           ws_ext_sales_price=T.DECIMAL(2),
                           ws_net_profit=T.DECIMAL(2),
                           ws_order_number=T.INT64,
                           ws_warehouse_sk=T.INT64,
                           ws_ship_date_sk=T.INT64,
                           ws_ext_ship_cost=T.DECIMAL(2),
                           ws_web_page_sk=T.INT64,
                           ws_sold_time_sk=T.INT64),
    "warehouse": Schema.of(w_warehouse_sk=T.INT64,
                           w_warehouse_name=T.STRING),
    "inventory": Schema.of(inv_date_sk=T.INT64, inv_item_sk=T.INT64,
                           inv_warehouse_sk=T.INT64,
                           inv_quantity_on_hand=T.INT32),
}

DIST_KEYS = {
    "date_dim": None, "item": None, "store": None,      # replicated dims
    "warehouse": None, "customer_address": None, "time_dim": None,
    "web_page": None,
    "customer": ("c_customer_sk",),
    "store_sales": ("ss_ticket_number",),
    "store_returns": ("sr_ticket_number",),
    "catalog_sales": ("cs_bill_customer_sk",),
    "catalog_returns": ("cr_order_number",),
    "web_sales": ("ws_bill_customer_sk",),
    "web_returns": ("wr_order_number",),
    "inventory": ("inv_item_sk",),
}

_STATES = ["TN", "CA", "TX", "WA", "NY", "GA", "OH", "MI"]
_WORDS = ["bright", "quiet", "amber", "rustic", "mellow", "crisp", "vivid",
          "plain", "brass", "linen"]


def generate(scale: float = 1.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_dates = 365 * 4                       # 1998-01-01 .. 2001-12-30
    n_item = max(int(500 * scale), 50)
    n_store = 12
    n_cust = max(int(2_000 * scale), 100)
    n_ss = max(int(30_000 * scale), 1_000)
    n_cs = max(int(20_000 * scale), 800)

    data: dict[str, dict[str, np.ndarray]] = {}

    base = date_to_days("1998-01-01")
    days = np.arange(n_dates, dtype=np.int64)
    dates = base + days
    years = 1998 + days // 365
    moy = (days % 365) // 31 + 1
    moy = np.clip(moy, 1, 12)
    _DAYNAMES = np.asarray(["Sunday", "Monday", "Tuesday", "Wednesday",
                            "Thursday", "Friday", "Saturday"],
                           dtype=object)
    data["date_dim"] = {
        "d_date_sk": days + 1,
        "d_date": dates,
        "d_year": years.astype(np.int32),
        "d_moy": moy.astype(np.int32),
        "d_quarter_name": np.asarray(
            [f"{y}Q{(m - 1) // 3 + 1}" for y, m in zip(years, moy)],
            dtype=object),
        # round-5 weekly columns (q43/q59): derived, no rng consumed.
        # 1998-01-01 was a Thursday; (dates + 4) % 7 == 0 on Sundays.
        "d_week_seq": ((days + 4) // 7 + 1).astype(np.int32),
        "d_day_name": _DAYNAMES[(dates + 4) % 7],
    }

    ik = np.arange(1, n_item + 1, dtype=np.int64)
    w = np.asarray(_WORDS, dtype=object)
    # round-4 reporting columns draw from their OWN stream: consuming the
    # shared rng here would shift every later table's draws and silently
    # re-tune the q17/q25/q29 filter selectivities
    rng2 = np.random.default_rng(seed + 104729)
    brand_id = rng2.integers(1, 12, n_item).astype(np.int32)
    classes = np.asarray(["alpha", "beta", "gamma", "delta"], dtype=object)
    cats = np.asarray(["Books", "Music", "Sports"], dtype=object)
    data["item"] = {
        "i_item_sk": ik,
        "i_item_id": np.asarray([f"ITEM{i:08d}" for i in ik], dtype=object),
        "i_item_desc": (w[rng.integers(0, 10, n_item)] + " "
                        + w[rng.integers(0, 10, n_item)]),
        "i_current_price": rng.integers(100, 10_000, n_item) / 100.0,
        "i_brand_id": brand_id,
        "i_brand": np.asarray([f"Brand#{b}" for b in brand_id],
                              dtype=object),
        "i_class": classes[rng2.integers(0, len(classes), n_item)],
        "i_category": cats[rng2.integers(0, len(cats), n_item)],
        "i_manufact_id": rng2.integers(1, 20, n_item).astype(np.int32),
        "i_manager_id": rng2.integers(1, 8, n_item).astype(np.int32),
    }

    sk = np.arange(1, n_store + 1, dtype=np.int64)
    data["store"] = {
        "s_store_sk": sk,
        "s_store_id": np.asarray([f"ST{i:06d}" for i in sk], dtype=object),
        "s_store_name": np.asarray([f"Store {i}" for i in sk], dtype=object),
        "s_state": np.asarray(_STATES, dtype=object)[
            rng.integers(0, len(_STATES), n_store)],
    }

    # round-5 customer identity + address columns on their OWN stream
    # (rng5): committed queries' selectivities are pinned to the existing
    # streams' draw sequences
    rng5 = np.random.default_rng(seed + 331337)
    n_ca = max(int(800 * scale), 80)
    firsts = np.asarray([f"First{i:02d}" for i in range(40)], dtype=object)
    lasts = np.asarray([f"Last{i:02d}" for i in range(60)], dtype=object)
    csk = np.arange(1, n_cust + 1, dtype=np.int64)
    data["customer"] = {
        "c_customer_sk": csk,
        "c_customer_id": np.asarray([f"CUST{i:09d}" for i in csk],
                                    dtype=object),
        "c_first_name": firsts[rng5.integers(0, len(firsts), n_cust)],
        "c_last_name": lasts[rng5.integers(0, len(lasts), n_cust)],
        "c_current_addr_sk": rng5.integers(1, n_ca + 1, n_cust)
        .astype(np.int64),
    }
    zips = np.asarray(
        [f"{p}{s:02d}" for p in ("850", "856", "859", "834", "772",
                                 "601", "331", "443")
         for s in range(25)], dtype=object)
    data["customer_address"] = {
        "ca_address_sk": np.arange(1, n_ca + 1, dtype=np.int64),
        "ca_state": np.asarray(_STATES, dtype=object)[
            rng5.integers(0, len(_STATES), n_ca)],
        "ca_zip": zips[rng5.integers(0, len(zips), n_ca)],
    }
    data["time_dim"] = {
        "t_time_sk": np.arange(1, 25, dtype=np.int64),
        "t_hour": np.arange(0, 24, dtype=np.int32),
    }
    n_wp = 10
    data["web_page"] = {
        "wp_web_page_sk": np.arange(1, n_wp + 1, dtype=np.int64),
        "wp_char_count": rng5.integers(1000, 9000, n_wp).astype(np.int32),
    }

    ss_date = rng.integers(1, n_dates + 1, n_ss)
    data["store_sales"] = {
        "ss_sold_date_sk": ss_date.astype(np.int64),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss).astype(np.int64),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_ss).astype(np.int64),
        "ss_ticket_number": np.arange(1, n_ss + 1, dtype=np.int64),
        "ss_store_sk": rng.integers(1, n_store + 1, n_ss).astype(np.int64),
        "ss_quantity": rng.integers(1, 100, n_ss).astype(np.int32),
        "ss_ext_sales_price": rng2.integers(100, 50_000, n_ss) / 100.0,
        "ss_net_profit": rng.integers(-5_000, 20_000, n_ss) / 100.0,
    }

    # ~35% of sales get returned within ~180 days
    ret_idx = np.sort(rng.choice(n_ss, size=int(n_ss * 0.35), replace=False))
    n_sr = len(ret_idx)
    sr_date = np.minimum(ss_date[ret_idx] + rng.integers(1, 180, n_sr),
                         n_dates)
    data["store_returns"] = {
        "sr_returned_date_sk": sr_date.astype(np.int64),
        "sr_item_sk": data["store_sales"]["ss_item_sk"][ret_idx],
        "sr_customer_sk": data["store_sales"]["ss_customer_sk"][ret_idx],
        "sr_ticket_number": data["store_sales"]["ss_ticket_number"][ret_idx],
        "sr_return_quantity": rng.integers(1, 50, n_sr).astype(np.int32),
        "sr_net_loss": rng.integers(50, 10_000, n_sr) / 100.0,
    }

    data["catalog_sales"] = {
        "cs_sold_date_sk": rng.integers(1, n_dates + 1, n_cs).astype(np.int64),
        "cs_item_sk": rng.integers(1, n_item + 1, n_cs).astype(np.int64),
        "cs_bill_customer_sk": rng.integers(1, n_cust + 1, n_cs)
        .astype(np.int64),
        "cs_quantity": rng.integers(1, 100, n_cs).astype(np.int32),
        "cs_net_profit": rng.integers(-5_000, 20_000, n_cs) / 100.0,
        # round-4 q20 column on its own stream: committed queries'
        # selectivities are pinned to the EXISTING streams' draw
        # sequences, so new columns never touch them
        "cs_ext_sales_price": np.random.default_rng(seed + 424243)
        .integers(100, 50_000, n_cs) / 100.0,
    }
    # round-5 fulfillment columns (q16/q99) on their own stream: orders
    # group ~3 lines; ~20% of lines ship from a second warehouse
    rng6 = np.random.default_rng(seed + 550551)
    n_ords = max(n_cs // 3, 1)
    cs_ord = rng6.integers(1, n_ords + 1, n_cs).astype(np.int64)
    data["catalog_sales"]["cs_order_number"] = cs_ord
    wh_of_order = rng6.integers(1, 5, n_ords + 1)
    cs_wh = wh_of_order[cs_ord]
    flip = rng6.random(n_cs) < 0.2
    cs_wh = np.where(flip, cs_wh % 4 + 1, cs_wh)
    data["catalog_sales"]["cs_warehouse_sk"] = cs_wh.astype(np.int64)
    data["catalog_sales"]["cs_ship_date_sk"] = np.minimum(
        data["catalog_sales"]["cs_sold_date_sk"]
        + rng6.integers(1, 150, n_cs), n_dates).astype(np.int64)
    data["catalog_sales"]["cs_ext_ship_cost"] = \
        rng6.integers(50, 5_000, n_cs) / 100.0
    ret_orders = rng6.choice(np.arange(1, n_ords + 1),
                             size=max(n_ords // 5, 1), replace=False)
    data["catalog_returns"] = {
        "cr_order_number": np.sort(ret_orders).astype(np.int64),
        "cr_return_amount": rng6.integers(100, 20_000,
                                          len(ret_orders)) / 100.0,
    }

    # web/inventory family (q12/q21/q86): OWN rng streams — consuming the
    # shared one would shift earlier tables' draws and silently re-tune
    # the committed queries' filter selectivities
    rng3 = np.random.default_rng(seed + 224737)
    n_ws = max(int(15_000 * scale), 600)
    data["web_sales"] = {
        "ws_sold_date_sk": rng3.integers(1, n_dates + 1, n_ws)
        .astype(np.int64),
        "ws_item_sk": rng3.integers(1, n_item + 1, n_ws).astype(np.int64),
        "ws_bill_customer_sk": rng3.integers(1, n_cust + 1, n_ws)
        .astype(np.int64),
        "ws_quantity": rng3.integers(1, 100, n_ws).astype(np.int32),
        "ws_ext_sales_price": rng3.integers(100, 50_000, n_ws) / 100.0,
        "ws_net_profit": rng3.integers(-5_000, 20_000, n_ws) / 100.0,
    }
    # round-5 web fulfillment columns (q90/q94) on their own stream
    rng7 = np.random.default_rng(seed + 770771)
    n_words = max(n_ws // 3, 1)
    ws_ord = rng7.integers(1, n_words + 1, n_ws).astype(np.int64)
    data["web_sales"]["ws_order_number"] = ws_ord
    wwh = rng7.integers(1, 5, n_words + 1)
    ws_wh = wwh[ws_ord]
    wflip = rng7.random(n_ws) < 0.2
    data["web_sales"]["ws_warehouse_sk"] = np.where(
        wflip, ws_wh % 4 + 1, ws_wh).astype(np.int64)
    data["web_sales"]["ws_ship_date_sk"] = np.minimum(
        data["web_sales"]["ws_sold_date_sk"]
        + rng7.integers(1, 150, n_ws), n_dates).astype(np.int64)
    data["web_sales"]["ws_ext_ship_cost"] = \
        rng7.integers(50, 5_000, n_ws) / 100.0
    data["web_sales"]["ws_web_page_sk"] = \
        rng7.integers(1, 11, n_ws).astype(np.int64)
    data["web_sales"]["ws_sold_time_sk"] = \
        rng7.integers(1, 25, n_ws).astype(np.int64)
    wret = rng7.choice(np.arange(1, n_words + 1),
                       size=max(n_words // 5, 1), replace=False)
    data["web_returns"] = {
        "wr_order_number": np.sort(wret).astype(np.int64),
        "wr_return_amt": rng7.integers(100, 20_000, len(wret)) / 100.0,
    }
    n_wh = 4
    data["warehouse"] = {
        "w_warehouse_sk": np.arange(1, n_wh + 1, dtype=np.int64),
        "w_warehouse_name": np.asarray(
            [f"Warehouse {i}" for i in range(1, n_wh + 1)], dtype=object),
    }
    n_inv = max(int(25_000 * scale), 1_000)
    data["inventory"] = {
        "inv_date_sk": rng3.integers(1, n_dates + 1, n_inv)
        .astype(np.int64),
        "inv_item_sk": rng3.integers(1, n_item + 1, n_inv)
        .astype(np.int64),
        "inv_warehouse_sk": rng3.integers(1, n_wh + 1, n_inv)
        .astype(np.int64),
        "inv_quantity_on_hand": rng3.integers(0, 1_000, n_inv)
        .astype(np.int32),
    }
    return data


def load_tpcds(session, scale: float = 1.0, seed: int = 0) -> None:
    from cloudberry_tpu_torch.tpch import load_tables

    load_tables(session, SCHEMAS, DIST_KEYS, generate(scale, seed))


# TPC-DS query texts (standard benchmark SQL; q17 keeps the official
# stddev_samp aggregates), adapted where tpcds-lite lacks a column.
QUERIES: dict[str, str] = {}

QUERIES["q17"] = """
select
    i_item_id, i_item_desc, s_state,
    count(ss_quantity) as store_sales_quantitycount,
    avg(ss_quantity) as store_sales_quantityave,
    stddev_samp(ss_quantity) as store_sales_quantitystdev,
    count(sr_return_quantity) as store_returns_quantitycount,
    avg(sr_return_quantity) as store_returns_quantityave,
    stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
    count(cs_quantity) as catalog_sales_quantitycount,
    avg(cs_quantity) as catalog_sales_quantityave,
    stddev_samp(cs_quantity) as catalog_sales_quantitystdev
from
    store_sales, store_returns, catalog_sales,
    date_dim d1, date_dim d2, date_dim d3, store, item
where
    d1.d_quarter_name = '2000Q1'
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_quarter_name in ('2000Q1', '2000Q2', '2000Q3')
    and sr_customer_sk = cs_bill_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_quarter_name in ('2000Q1', '2000Q2', '2000Q3')
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
"""

QUERIES["q25"] = """
select
    i_item_id, i_item_desc, s_store_id, s_store_name,
    sum(ss_net_profit) as store_sales_profit,
    sum(sr_net_loss) as store_returns_loss,
    sum(cs_net_profit) as catalog_sales_profit
from
    store_sales, store_returns, catalog_sales,
    date_dim d1, date_dim d2, date_dim d3, store, item
where
    d1.d_moy = 4
    and d1.d_year = 2000
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_moy between 4 and 10
    and d2.d_year = 2000
    and sr_customer_sk = cs_bill_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_moy between 4 and 10
    and d3.d_year = 2000
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
"""

QUERIES["q29"] = """
select
    i_item_id, i_item_desc, s_store_id, s_store_name,
    sum(ss_quantity) as store_sales_quantity,
    sum(sr_return_quantity) as store_returns_quantity,
    sum(cs_quantity) as catalog_sales_quantity
from
    store_sales, store_returns, catalog_sales,
    date_dim d1, date_dim d2, date_dim d3, store, item
where
    d1.d_moy = 4
    and d1.d_year = 1999
    and d1.d_date_sk = ss_sold_date_sk
    and i_item_sk = ss_item_sk
    and s_store_sk = ss_store_sk
    and ss_customer_sk = sr_customer_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and sr_returned_date_sk = d2.d_date_sk
    and d2.d_moy between 4 and 7
    and d2.d_year = 1999
    and sr_customer_sk = cs_bill_customer_sk
    and sr_item_sk = cs_item_sk
    and cs_sold_date_sk = d3.d_date_sk
    and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
"""

# -------- star-schema reporting subset (round 4): q3/q42/q52/q55/q98 —
# single-fact joins over brand/category/manager dimensions; q98 adds the
# revenue-ratio window over a grouped aggregate.

QUERIES["q3"] = """
select d_year, i_brand_id, i_brand, sum(ss_net_profit) as sum_agg
from date_dim dt join store_sales on dt.d_date_sk = ss_sold_date_sk
     join item on ss_item_sk = i_item_sk
where i_manufact_id = 7 and dt.d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
"""

QUERIES["q42"] = """
select d_year, i_category, sum(ss_ext_sales_price) as total
from date_dim dt join store_sales on dt.d_date_sk = ss_sold_date_sk
     join item on ss_item_sk = i_item_sk
where d_moy = 11 and d_year = 2000
group by d_year, i_category
order by total desc, d_year, i_category
limit 100
"""

QUERIES["q52"] = """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) as ext_price
from date_dim dt join store_sales on dt.d_date_sk = ss_sold_date_sk
     join item on ss_item_sk = i_item_sk
where i_manager_id = 1 and d_moy = 12 and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, i_brand_id
limit 100
"""

QUERIES["q55"] = """
select i_brand_id, i_brand, sum(ss_ext_sales_price) as ext_price
from date_dim join store_sales on d_date_sk = ss_sold_date_sk
     join item on ss_item_sk = i_item_sk
where i_manager_id = 3 and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, i_brand_id
limit 100
"""

QUERIES["q98"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) as itemrevenue,
       sum(ss_ext_sales_price) * 100.0
           / sum(sum(ss_ext_sales_price)) over (partition by i_class)
           as revenueratio
from store_sales join item on ss_item_sk = i_item_sk
     join date_dim on ss_sold_date_sk = d_date_sk
where i_category in ('Books', 'Music')
  and d_date between date '2000-02-01' and date '2000-03-01'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

# -------- web/inventory family (round 4): q12/q21/q86 over the
# web_sales + inventory + warehouse tables.

QUERIES["q12"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) as itemrevenue,
       sum(ws_ext_sales_price) * 100 / sum(sum(ws_ext_sales_price))
         over (partition by i_class) as revenueratio
from web_sales join item on ws_item_sk = i_item_sk
     join date_dim on ws_sold_date_sk = d_date_sk
where i_category in ('Sports', 'Books')
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

QUERIES["q20"] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) as itemrevenue,
       sum(cs_ext_sales_price) * 100 / sum(sum(cs_ext_sales_price))
         over (partition by i_class) as revenueratio
from catalog_sales join item on cs_item_sk = i_item_sk
     join date_dim on cs_sold_date_sk = d_date_sk
where i_category in ('Sports', 'Music')
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
"""

# q21 (adapted: price band widened to the generated price range)
QUERIES["q21"] = """
select * from (
  select w_warehouse_name, i_item_id,
         sum(case when d_date < date '2000-03-11'
                  then inv_quantity_on_hand else 0 end) as inv_before,
         sum(case when d_date >= date '2000-03-11'
                  then inv_quantity_on_hand else 0 end) as inv_after
  from inventory join warehouse on inv_warehouse_sk = w_warehouse_sk
       join item on i_item_sk = inv_item_sk
       join date_dim on inv_date_sk = d_date_sk
  where i_current_price between 0.99 and 10.00
    and d_date between date '2000-03-11' - interval '30' day
                   and date '2000-03-11' + interval '30' day
  group by w_warehouse_name, i_item_id) x
where case when inv_before > 0
           then 1.0 * inv_after / inv_before else null end
      between 2.0 / 3.0 and 3.0 / 2.0
order by w_warehouse_name, i_item_id
limit 100
"""

# q86 (adapted: ws_net_paid -> ws_net_profit, d_month_seq -> d_year)
QUERIES["q86"] = """
select sum(ws_net_profit) as total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (
         partition by grouping(i_category) + grouping(i_class),
           case when grouping(i_class) = 0 then i_category end
         order by sum(ws_net_profit) desc
       ) as rank_within_parent
from web_sales join date_dim d1 on d1.d_date_sk = ws_sold_date_sk
     join item on i_item_sk = ws_item_sk
where d1.d_year = 2000
group by rollup (i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
"""

# q65 (adapted: d_month_seq window -> d_year, ss_sales_price ->
# ss_ext_sales_price, i_wholesale_cost dropped — tpcds-lite does not
# generate them; the shape is the point: two aggregated derived tables
# joined with a cross-derived-table arithmetic predicate)
QUERIES["q65"] = """
select s_store_name, i_item_desc, sc.revenue, i_current_price, i_brand
from store join
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk,
                   sum(ss_ext_sales_price) as revenue
            from store_sales join date_dim on ss_sold_date_sk = d_date_sk
            where d_year = 2000
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb on s_store_sk = sb.ss_store_sk
     join
     (select ss_store_sk, ss_item_sk,
             sum(ss_ext_sales_price) as revenue
      from store_sales join date_dim on ss_sold_date_sk = d_date_sk
      where d_year = 2000
      group by ss_store_sk, ss_item_sk) sc
     on sb.ss_store_sk = sc.ss_store_sk
     join item on i_item_sk = sc.ss_item_sk
where sc.revenue <= 0.1 * sb.ave
order by s_store_name, i_item_desc, revenue, i_current_price, i_brand
limit 100
"""

# q36 (adapted: s_state list uses generated states; the shape is the
# point — ROLLUP + grouping() driving a rank() window over aggregate
# outputs, ordered by the grouping level)
QUERIES["q36"] = """
select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (
         partition by grouping(i_category) + grouping(i_class),
           case when grouping(i_class) = 0 then i_category end
         order by sum(ss_net_profit) / sum(ss_ext_sales_price)
       ) as rank_within_parent
from store_sales join date_dim on d_date_sk = ss_sold_date_sk
     join item on i_item_sk = ss_item_sk
     join store on s_store_sk = ss_store_sk
where d_year = 2001 and s_state in ('TN', 'CA', 'TX', 'WA')
group by rollup (i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
"""

# q27 (adapted: the official query filters on customer_demographics,
# which tpcds-lite does not generate — the grouping shape, the rollup,
# and grouping() are the point here; avgs run over the generated
# measure columns)
QUERIES["q27"] = """
select i_item_id, s_state, grouping(s_state) as g_state,
       avg(ss_quantity) as agg1,
       avg(ss_ext_sales_price) as agg2,
       avg(ss_net_profit) as agg3
from store_sales join date_dim on ss_sold_date_sk = d_date_sk
     join store on ss_store_sk = s_store_sk
     join item on ss_item_sk = i_item_sk
where d_year = 2000
group by rollup (i_item_id, s_state)
order by i_item_id, s_state
limit 100
"""

# -------- round 5: families that force NEW binder/executor surface —
# mixed distinct aggregates + EXISTS/NOT EXISTS (q16/q94), INTERSECT
# count (q38), CASE day-of-week pivots (q43/q59), cross-channel CTE
# unions with IN-subqueries (q33/q56/q60), year-over-year CTE self-joins
# (q74), DQA-in-scalar-subquery ratio (q90), LEFT-join actual-sales
# (q93), FULL-join channel overlap (q97), ship-delay buckets (q99),
# correlated-average item filter (q6), zip/state OR filters (q15).
# Adaptations from the official text (columns tpcds-lite does not
# generate: call centers, ship modes, web sites, demographics, gmt
# offsets; d_month_seq windows -> d_year) are noted per query.

# q6 (adapted: month filter via d_year/d_moy; the correlated average
# is compared as "avg < price / 1.2" — same predicate, in the shape the
# decorrelator recognizes)
QUERIES["q6"] = """
select a.ca_state as state, count(*) as cnt
from customer_address a join customer c
       on a.ca_address_sk = c.c_current_addr_sk
     join store_sales s on c.c_customer_sk = s.ss_customer_sk
     join date_dim d on s.ss_sold_date_sk = d.d_date_sk
     join item i on s.ss_item_sk = i.i_item_sk
where d.d_year = 2000 and d.d_moy = 5
  and (select avg(j.i_current_price) from item j
       where j.i_category = i.i_category) < i.i_current_price / 1.2
group by a.ca_state
having count(*) >= 10
order by cnt, a.ca_state
limit 100
"""

# q15 (adapted: qoy -> d_moy, sales-price threshold over generated range)
QUERIES["q15"] = """
select ca_zip, sum(cs_ext_sales_price) as total
from catalog_sales join customer on cs_bill_customer_sk = c_customer_sk
     join customer_address on c_current_addr_sk = ca_address_sk
     join date_dim on cs_sold_date_sk = d_date_sk
where (substring(ca_zip, 1, 3) in ('850', '856', '859', '834')
       or ca_state in ('CA', 'WA', 'GA')
       or cs_ext_sales_price > 480)
  and d_year = 2001 and d_moy = 1
group by ca_zip
order by ca_zip
limit 100
"""

# q16 (adapted: no call-center dimension; ship-date window via d_date)
QUERIES["q16"] = """
select count(distinct cs_order_number) as order_count,
       sum(cs_ext_ship_cost) as total_shipping_cost,
       sum(cs_net_profit) as total_net_profit
from catalog_sales cs1
     join date_dim on cs1.cs_ship_date_sk = d_date_sk
     join warehouse on cs1.cs_warehouse_sk = w_warehouse_sk
where d_date between date '1999-02-01'
                 and date '1999-02-01' + interval '60' day
  and exists (select 1 from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select 1 from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
limit 100
"""

# q33 (adapted: no ca_gmt_offset; manufacturer set from the Books
# category, May 1998)
QUERIES["q33"] = """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) as total_sales
  from store_sales join date_dim on ss_sold_date_sk = d_date_sk
       join item on ss_item_sk = i_item_sk
  where i_manufact_id in (select it2.i_manufact_id from item it2
                          where it2.i_category = 'Books')
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id),
cs as (
  select i_manufact_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales join date_dim on cs_sold_date_sk = d_date_sk
       join item on cs_item_sk = i_item_sk
  where i_manufact_id in (select it2.i_manufact_id from item it2
                          where it2.i_category = 'Books')
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id),
ws as (
  select i_manufact_id, sum(ws_ext_sales_price) as total_sales
  from web_sales join date_dim on ws_sold_date_sk = d_date_sk
       join item on ws_item_sk = i_item_sk
  where i_manufact_id in (select it2.i_manufact_id from item it2
                          where it2.i_category = 'Books')
    and d_year = 1998 and d_moy = 5
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
"""

# q38 (adapted: d_month_seq window -> d_year)
QUERIES["q38"] = """
select count(*) as cnt from (
  (select distinct c_last_name, c_first_name, d_date
   from store_sales join date_dim on ss_sold_date_sk = d_date_sk
        join customer on ss_customer_sk = c_customer_sk
   where d_year = 1999)
  intersect
  (select distinct c_last_name, c_first_name, d_date
   from catalog_sales join date_dim on cs_sold_date_sk = d_date_sk
        join customer on cs_bill_customer_sk = c_customer_sk
   where d_year = 1999)
  intersect
  (select distinct c_last_name, c_first_name, d_date
   from web_sales join date_dim on ws_sold_date_sk = d_date_sk
        join customer on ws_bill_customer_sk = c_customer_sk
   where d_year = 1999)
) hot_cust
limit 100
"""

# q43 (adapted: gmt offset dropped; measure is ss_ext_sales_price)
QUERIES["q43"] = """
select s_store_name, s_store_id,
  sum(case when d_day_name = 'Sunday' then ss_ext_sales_price
           else null end) as sun_sales,
  sum(case when d_day_name = 'Monday' then ss_ext_sales_price
           else null end) as mon_sales,
  sum(case when d_day_name = 'Tuesday' then ss_ext_sales_price
           else null end) as tue_sales,
  sum(case when d_day_name = 'Wednesday' then ss_ext_sales_price
           else null end) as wed_sales,
  sum(case when d_day_name = 'Thursday' then ss_ext_sales_price
           else null end) as thu_sales,
  sum(case when d_day_name = 'Friday' then ss_ext_sales_price
           else null end) as fri_sales,
  sum(case when d_day_name = 'Saturday' then ss_ext_sales_price
           else null end) as sat_sales
from date_dim join store_sales on d_date_sk = ss_sold_date_sk
     join store on s_store_sk = ss_store_sk
where d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100
"""

# q56 (adapted: i_color -> i_class filter; September 2000)
QUERIES["q56"] = """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales join date_dim on ss_sold_date_sk = d_date_sk
       join item on ss_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_class in ('alpha', 'beta'))
    and d_year = 2000 and d_moy = 9
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales join date_dim on cs_sold_date_sk = d_date_sk
       join item on cs_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_class in ('alpha', 'beta'))
    and d_year = 2000 and d_moy = 9
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales join date_dim on ws_sold_date_sk = d_date_sk
       join item on ws_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_class in ('alpha', 'beta'))
    and d_year = 2000 and d_moy = 9
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
"""

# q59 (adapted: the d_month_seq windows become explicit week ranges and
# the year-over-year match is d_week_seq = d_week_seq2 - 52; measure is
# ss_ext_sales_price)
QUERIES["q59"] = """
with wss as (
  select d_week_seq, ss_store_sk,
    sum(case when d_day_name = 'Sunday' then ss_ext_sales_price
             else null end) as sun_sales,
    sum(case when d_day_name = 'Monday' then ss_ext_sales_price
             else null end) as mon_sales,
    sum(case when d_day_name = 'Friday' then ss_ext_sales_price
             else null end) as fri_sales,
    sum(case when d_day_name = 'Saturday' then ss_ext_sales_price
             else null end) as sat_sales
  from store_sales join date_dim on d_date_sk = ss_sold_date_sk
  group by d_week_seq, ss_store_sk)
select y.s_store_name1, y.s_store_id1, y.d_week_seq1,
       y.sun_sales1 / x.sun_sales2 as sun_r,
       y.mon_sales1 / x.mon_sales2 as mon_r,
       y.fri_sales1 / x.fri_sales2 as fri_r,
       y.sat_sales1 / x.sat_sales2 as sat_r
from (select s_store_name as s_store_name1, wss.d_week_seq as d_week_seq1,
             s_store_id as s_store_id1, sun_sales as sun_sales1,
             mon_sales as mon_sales1, fri_sales as fri_sales1,
             sat_sales as sat_sales1
      from wss join store on ss_store_sk = s_store_sk
      where d_week_seq between 27 and 52) y
     join
     (select s_store_name as s_store_name2, wss.d_week_seq as d_week_seq2,
             s_store_id as s_store_id2, sun_sales as sun_sales2,
             mon_sales as mon_sales2, fri_sales as fri_sales2,
             sat_sales as sat_sales2
      from wss join store on ss_store_sk = s_store_sk
      where d_week_seq between 79 and 104) x
     on y.s_store_id1 = x.s_store_id2
    and y.d_week_seq1 = x.d_week_seq2 - 52
order by y.s_store_name1, y.s_store_id1, y.d_week_seq1
limit 100
"""

# q60 (adapted: no gmt offset; Music category, September 1999)
QUERIES["q60"] = """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales join date_dim on ss_sold_date_sk = d_date_sk
       join item on ss_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_category = 'Music')
    and d_year = 1999 and d_moy = 9
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales join date_dim on cs_sold_date_sk = d_date_sk
       join item on cs_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_category = 'Music')
    and d_year = 1999 and d_moy = 9
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales join date_dim on ws_sold_date_sk = d_date_sk
       join item on ws_item_sk = i_item_sk
  where i_item_id in (select it2.i_item_id from item it2
                      where it2.i_category = 'Music')
    and d_year = 1999 and d_moy = 9
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100
"""

# q74 (adapted: the sale-type discriminator is numeric (1 = store,
# 2 = web) — the shape under test is the 4-instance CTE self-join with
# the guarded ratio comparison)
QUERIES["q74"] = """
with year_total as (
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_, sum(ss_ext_sales_price) as year_total,
         1 as sale_type
  from customer join store_sales on c_customer_sk = ss_customer_sk
       join date_dim on ss_sold_date_sk = d_date_sk
  where d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_, sum(ws_ext_sales_price) as year_total,
         2 as sale_type
  from customer join web_sales on c_customer_sk = ws_bill_customer_sk
       join date_dim on ws_sold_date_sk = d_date_sk
  where d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.c_first_name,
       t_s_secyear.c_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 1 and t_w_firstyear.sale_type = 2
  and t_s_secyear.sale_type = 1 and t_w_secyear.sale_type = 2
  and t_s_firstyear.year_ = 1999 and t_s_secyear.year_ = 2000
  and t_w_firstyear.year_ = 1999 and t_w_secyear.year_ = 2000
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else null end
      > case when t_s_firstyear.year_total > 0
             then t_s_secyear.year_total / t_s_firstyear.year_total
             else null end
order by t_s_secyear.customer_id, t_s_secyear.c_first_name,
         t_s_secyear.c_last_name
limit 100
"""

# q90 (adapted: the am/pm ratio is expressed through uncorrelated
# scalar subqueries — the cross join of two one-row derived tables is
# the same computation)
QUERIES["q90"] = """
select (select count(distinct ws_order_number)
        from web_sales join time_dim on ws_sold_time_sk = t_time_sk
             join web_page on ws_web_page_sk = wp_web_page_sk
        where t_hour between 8 and 9
          and wp_char_count between 2000 and 5000)
       / (select count(distinct ws_order_number)
          from web_sales join time_dim on ws_sold_time_sk = t_time_sk
               join web_page on ws_web_page_sk = wp_web_page_sk
          where t_hour between 19 and 20
            and wp_char_count between 2000 and 5000) as am_pm_ratio
"""

# q93 (adapted: no reason dimension — returned lines subtract their
# returned quantity; measure is ss_ext_sales_price as the unit price
# proxy)
QUERIES["q93"] = """
select ss_customer_sk, sum(act_sales) as sumsales
from (select ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity)
                       * ss_ext_sales_price
                  else ss_quantity * ss_ext_sales_price end as act_sales
      from store_sales left join store_returns
           on sr_item_sk = ss_item_sk
          and sr_ticket_number = ss_ticket_number) t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
"""

# q94 (adapted: no web_site dimension; ship-date window via d_date)
QUERIES["q94"] = """
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1
     join date_dim on ws1.ws_ship_date_sk = d_date_sk
     join warehouse on ws1.ws_warehouse_sk = w_warehouse_sk
where d_date between date '1999-02-01'
                 and date '1999-02-01' + interval '60' day
  and exists (select 1 from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select 1 from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
limit 100
"""

# q97
QUERIES["q97"] = """
with ssci as (
  select ss_customer_sk as customer_sk, ss_item_sk as item_sk
  from store_sales join date_dim on ss_sold_date_sk = d_date_sk
  where d_year = 2000
  group by ss_customer_sk, ss_item_sk),
csci as (
  select cs_bill_customer_sk as customer_sk, cs_item_sk as item_sk
  from catalog_sales join date_dim on cs_sold_date_sk = d_date_sk
  where d_year = 2000
  group by cs_bill_customer_sk, cs_item_sk)
select sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is null then 1 else 0 end)
         as store_only,
       sum(case when ssci.customer_sk is null
                 and csci.customer_sk is not null then 1 else 0 end)
         as catalog_only,
       sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is not null then 1 else 0 end)
         as store_and_catalog
from ssci full join csci
     on ssci.customer_sk = csci.customer_sk
    and ssci.item_sk = csci.item_sk
limit 100
"""

# q99 (adapted: warehouse replaces the call-center/ship-mode grouping;
# the delay buckets are the official 30/60/90/120-day CASE pivot)
QUERIES["q99"] = """
select w_warehouse_name,
  sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
           then 1 else 0 end) as d30,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
            and cs_ship_date_sk - cs_sold_date_sk <= 60
           then 1 else 0 end) as d60,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
            and cs_ship_date_sk - cs_sold_date_sk <= 90
           then 1 else 0 end) as d90,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 90
            and cs_ship_date_sk - cs_sold_date_sk <= 120
           then 1 else 0 end) as d120,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 120
           then 1 else 0 end) as dmore
from catalog_sales join warehouse on cs_warehouse_sk = w_warehouse_sk
group by w_warehouse_name
order by w_warehouse_name
limit 100
"""


# Not a TPC-DS query: one statement over store_sales (with date_dim for a
# date key) that runs every window function family and frame kind the
# executor lowers — the default frame with ORDER BY, ROWS offsets, a
# numeric RANGE offset, a RANGE offset of one calendar month, a ROWS-frame
# max (sparse table), a running max (segmented scan), a whole-partition
# min (re-sort), ranks, ntile, lead/lag with and without a default, and
# first/last_value. Positional functions order by the ticket number, which
# is unique, so the answer is fixed by SQL and not by tie order. ``{where}``
# selects the rows.
_BY_TICKET = "(partition by ss_store_sk order by ss_ticket_number)"
WINDOW_QUERY = """
select ss_ticket_number, ss_store_sk, d_date,
       row_number() over T as rn,
       rank() over (partition by ss_store_sk order by ss_quantity desc)
           as qty_rank,
       dense_rank() over (partition by ss_store_sk
                          order by ss_quantity desc) as qty_dense_rank,
       sum(ss_net_profit) over T as running_profit,
       avg(ss_ext_sales_price) over (partition by ss_store_sk
           order by ss_ticket_number
           rows between 3 preceding and 2 following) as moving_avg,
       count(*) over (partition by ss_store_sk order by ss_quantity
           range between 5 preceding and 5 following) as qty_band,
       sum(ss_quantity) over (partition by ss_store_sk order by d_date
           range between interval '1' month preceding and current row)
           as month_qty,
       max(ss_net_profit) over (partition by ss_store_sk
           order by ss_ticket_number
           rows between 10 preceding and current row) as rows_max,
       max(ss_ext_sales_price) over T as running_max,
       min(ss_net_profit) over (partition by ss_store_sk) as store_min,
       ntile(4) over T as quartile,
       lead(ss_quantity, 1, -1) over T as next_qty,
       lag(ss_quantity, 2) over T as prev2_qty,
       first_value(ss_item_sk) over T as first_item,
       last_value(ss_item_sk) over (partition by ss_store_sk
           order by ss_ticket_number
           rows between current row and 5 following) as last_item
from store_sales join date_dim on ss_sold_date_sk = d_date_sk
where {where}
""".replace(" T ", " " + _BY_TICKET + " ")
