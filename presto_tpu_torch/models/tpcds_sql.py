"""TPC-DS benchmark query texts (north-star pair Q64 + Q72, plus a breadth
set: 22 queries in ``QUERIES``).

The PyTorch port's copy of ``presto_tpu/models/tpcds_sql.py`` (plain Python, no
torch): the port keeps its own query texts so that it imports nothing of
``presto_tpu``.

Spec-defined queries (TPC-DS v2 templates; reference copies live in
presto-benchto-benchmarks/src/main/resources/sql/presto/tpcds/qNN.sql)
adapted to bare table names, this engine's dialect, and this generator's
column subset: name-valued dimension attributes the generator does not
synthesize (i_brand, i_category, s_state, i_manager_id, promotion channel
flags) are replaced by their id-valued columns or dropped filters — the
query SHAPES (join trees, aggregations, rollups, TopN) are preserved, and
every query is verified against the sqlite oracle over identical data.
"""

Q64 = """
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit) as refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk
    and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
),
cross_sales as (
  select i_product_name as product_name,
         i_item_sk as item_sk,
         s_store_name as store_name,
         s_zip as store_zip,
         ad1.ca_street_number as b_street_number,
         ad1.ca_street_name as b_street_name,
         ad1.ca_city as b_city,
         ad1.ca_zip as b_zip,
         ad2.ca_street_number as c_street_number,
         ad2.ca_street_name as c_street_name,
         ad2.ca_city as c_city,
         ad2.ca_zip as c_zip,
         d1.d_year as syear,
         d2.d_year as fsyear,
         d3.d_year as s2year,
         count(*) as cnt,
         sum(ss_wholesale_cost) as s1,
         sum(ss_list_price) as s2,
         sum(ss_coupon_amt) as s3
  from store_sales, store_returns, cs_ui,
       date_dim d1, date_dim d2, date_dim d3,
       store, customer,
       customer_demographics cd1, customer_demographics cd2,
       promotion,
       household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2,
       income_band ib1, income_band ib2, item
  where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk
    and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk
    and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring', 'floral',
                    'medium')
    and i_current_price between 64 and 64 + 10
    and i_current_price between 64 + 1 and 64 + 15
  group by i_item_sk, i_product_name, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city, ad1.ca_zip,
           ad2.ca_street_number, ad2.ca_street_name, ad2.ca_city, ad2.ca_zip,
           d1.d_year, d2.d_year, d3.d_year
)
select cs1.product_name,
       cs1.store_name,
       cs1.store_zip,
       cs1.b_street_number,
       cs1.b_street_name,
       cs1.b_city,
       cs1.b_zip,
       cs1.c_street_number,
       cs1.c_street_name,
       cs1.c_city,
       cs1.c_zip,
       cs1.syear,
       cs1.cnt,
       cs1.s1 as s11,
       cs1.s2 as s21,
       cs1.s3 as s31,
       cs2.s1 as s12,
       cs2.s2 as s22,
       cs2.s3 as s32,
       cs2.syear as syear2,
       cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 1999
  and cs2.syear = 1999 + 1
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cs2.cnt, 14, 15, 16, 17, 18
"""

Q72 = """
select i_item_desc,
       w_warehouse_name,
       d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) as no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) as promo,
       count(*) as total_cnt
from catalog_sales
inner join inventory on cs_item_sk = inv_item_sk
inner join warehouse on w_warehouse_sk = inv_warehouse_sk
inner join item on i_item_sk = cs_item_sk
inner join customer_demographics on cs_bill_cdemo_sk = cd_demo_sk
inner join household_demographics on cs_bill_hdemo_sk = hd_demo_sk
inner join date_dim d1 on cs_sold_date_sk = d1.d_date_sk
inner join date_dim d2 on inv_date_sk = d2.d_date_sk
inner join date_dim d3 on cs_ship_date_sk = d3.d_date_sk
left join promotion on cs_promo_sk = p_promo_sk
left join catalog_returns on cr_item_sk = cs_item_sk
                         and cr_order_number = cs_order_number
where d1.d_week_seq = d2.d_week_seq
  and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + interval '5' day
  and hd_buy_potential = '>10000'
  and d1.d_year = 1999
  and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
"""

Q3 = """
select d_year, i_brand_id, sum(ss_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id = 128
  and d_moy = 11
group by d_year, i_brand_id
order by d_year, sum_agg desc, i_brand_id
limit 100
"""

Q7 = """
select i_item_id,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and p_response_target = 1
  and d_year = 1999
group by i_item_id
order by i_item_id
limit 100
"""

Q19 = """
select i_brand_id, i_manufact_id, sum(ss_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_category_id = 7
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ss_store_sk = s_store_sk
  and ca_zip <> s_zip
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_manufact_id
order by ext_price desc, i_brand_id, i_manufact_id
limit 100
"""

Q25 = """
select i_item_id, i_item_desc, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_return_amt) as store_returns_loss,
       sum(cs_sales_price) as catalog_sales_price
from store_sales, store_returns, catalog_sales, date_dim, store, item
where ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and ss_sold_date_sk = d_date_sk
  and d_moy = 4
  and d_year = 1999
  and ss_store_sk = s_store_sk
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, s_store_name
order by i_item_id, i_item_desc, s_store_name
limit 100
"""

Q36 = """
select sum(ss_net_profit) as total_profit,
       i_category_id, i_class_id,
       grouping(i_category_id) + grouping(i_class_id) as lochierarchy,
       count(*) as cnt
from store_sales, date_dim, item, store
where d_year = 1999
  and d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
group by rollup(i_category_id, i_class_id)
order by lochierarchy desc, i_category_id, i_class_id
limit 100
"""

Q42 = """
select d_year, i_category_id, sum(ss_sales_price) as total_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and d_moy = 11
  and d_year = 1999
group by d_year, i_category_id
order by total_price desc, d_year, i_category_id
limit 100
"""

Q52 = """
select d_year, i_brand_id, sum(ss_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and d_moy = 12
  and d_year = 1998
group by d_year, i_brand_id
order by d_year, ext_price desc, i_brand_id
limit 100
"""

Q55 = """
select i_brand_id, sum(ss_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_class_id = 5
  and d_moy = 11
  and d_year = 1999
group by i_brand_id
order by ext_price desc, i_brand_id
limit 100
"""

Q21 = """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '1999-03-11'
                then inv_quantity_on_hand else 0 end) as inv_before,
       sum(case when d_date >= date '1999-03-11'
                then inv_quantity_on_hand else 0 end) as inv_after
from inventory, warehouse, item, date_dim
where i_current_price between 0.99 and 1.49
  and i_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and d_date between date '1999-02-10' and date '1999-04-10'
group by w_warehouse_name, i_item_id
order by w_warehouse_name, i_item_id
limit 100
"""

Q82 = """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 30 and 60
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '1999-05-25' and date '1999-07-24'
  and i_manufact_id in (129, 270, 821, 423, 500, 501, 502, 503)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
"""

Q13 = """
select avg(ss_quantity), avg(ss_ext_sales_price), avg(ss_ext_wholesale_cost),
       sum(ss_ext_wholesale_cost)
from store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
        and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 150.00
        and hd_dep_count = 3)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00 and hd_dep_count = 1)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'W'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 150.00 and 200.00 and hd_dep_count = 1))
  and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
  and ca_country = 'United States'
  and ((ca_state in ('TX','OH','TX') and ss_net_profit between 100 and 200)
    or (ca_state in ('OR','NM','KY') and ss_net_profit between 150 and 300)
    or (ca_state in ('VA','TX','MS') and ss_net_profit between 50 and 250))
"""
Q15 = """
select ca_zip, sum(cs_sales_price)
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substr(ca_zip, 1, 5) in ('85669','86197','88274','83405','86475',
                                '85392','85460','80348','81792')
       or ca_state in ('CA','WA','GA') or cs_sales_price > 500)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2001
group by ca_zip order by ca_zip limit 100
"""
Q26 = """
select i_item_id, avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cs_promo_sk = p_promo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N') and d_year = 2000
group by i_item_id order by i_item_id limit 100
"""
Q43 = """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and s_gmt_offset = -5 and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales, wed_sales,
         thu_sales, fri_sales, sat_sales
limit 100
"""
Q48 = """
select sum(ss_quantity)
from store_sales, store, customer_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2000
  and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'D'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 150.00 and 200.00))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('CO','OH','TX') and ss_net_profit between 0 and 2000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR','MN','KY') and ss_net_profit between 150 and 3000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA','CA','MS') and ss_net_profit between 50 and 25000))
"""
Q50 = """
select s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30) then 1
                else 0 end) as d30,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 60) then 1
                else 0 end) as d60,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 90) then 1
                else 0 end) as d90,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 90) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 120) then 1
                else 0 end) as d120,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 120) then 1
                else 0 end) as dmore
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and ss_sold_date_sk = d1.d_date_sk and sr_returned_date_sk = d2.d_date_sk
  and ss_customer_sk = sr_customer_sk and ss_store_sk = s_store_sk
group by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
order by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
limit 100
"""
Q46 = """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city bought_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics, customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and (hd_dep_count = 4 or hd_vehicle_count = 3)
        and d_dow in (6, 0) and d_year = 1999
        and s_city in ('Fairview', 'Midway')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
limit 100
"""
Q73 = """
select c_birth_year, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dom between 1 and 2
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and d_year = 2000 and s_county in ('Williamson County', 'Walker County')
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_birth_year
limit 100
"""
Q79 = """
select c_birth_year, s_city, ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
        and d_dow = 1 and d_year = 2000
        and s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_store_sk, s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_birth_year, amt, profit, ss_ticket_number
limit 100
"""
Q27 = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2000
group by rollup (i_item_id, s_state)
order by i_item_id, s_state
limit 100
"""

QUERIES = {3: Q3, 7: Q7, 13: Q13, 15: Q15, 19: Q19, 21: Q21, 25: Q25,
           26: Q26, 27: Q27, 36: Q36, 42: Q42, 43: Q43, 46: Q46, 48: Q48, 50: Q50,
           52: Q52, 55: Q55, 64: Q64, 72: Q72, 73: Q73, 79: Q79,
           82: Q82}
